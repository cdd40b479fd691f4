"""Rank 0's FLOPs of a tiny train step on a (2, 2, 2) ``pod, data,
model`` mesh, the port's count against the reference's partitioned
compile, each split by op: the port's by aten op (``launch.dryrun.
mesh_count`` under a counter that notes each op's FLOPs), the
reference's into its dots and the rest (``hlo_analysis`` of the step
compiled for eight forced host devices, in a subprocess).  CPU only.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/mesh_flops_split.py \\
        [--config dense|moe] [--moe-groups 4]

The configs are the tiny ones of ``tests/test_torch_dtensor.py`` (dense)
and ``tests/test_torch_dtensor_moe.py`` (moe), at their 8 x 128 train
shape.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict

CONFIGS = {
    "dense": dict(name="tiny-dense", family="dense", n_layers=2,
                  d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                  vocab_size=256, head_dim=16),
    "moe": dict(name="tiny-moe", family="moe", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=32, vocab_size=256,
                head_dim=16, qk_norm=True, n_experts=4,
                experts_per_token=2, capacity_factor=1.0),
}
SHAPE = ("tiny train", "train", 128, 8)

REF = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs.base import ModelConfig, ShapeConfig
from repro.distributed.ctx import activation_sharding
from repro.distributed.sharding import (batch_specs, data_axes, named,
                                        opt_specs, param_specs)
from repro.launch import hlo_analysis as H
from repro.launch.steps import (input_specs, make_train_step, opt_shape,
                                params_shape)
from repro.optim.adamw import AdamWConfig
cfg = ModelConfig(**json.loads(sys.argv[1]))
shape = ShapeConfig(*json.loads(sys.argv[2]))
groups = int(sys.argv[3])
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
    hlo = jitted.lower(pshape, opt_shape(cfg, opt_cfg),
                       input_specs(cfg, shape)).compile().as_text()
total = H.analyze_hlo(hlo, 8).flops
H.HloAnalyzer._dot_flops = lambda self, comp, ins: 0.0
rest = H.analyze_hlo(hlo, 8).flops
print("REF", json.dumps({"flops": total, "dot": total - rest,
                         "not_dot": rest}))
"""


def port_split(cfg, groups):
    """Rank 0's count, and its FLOPs by aten op (the kernels' by
    name)."""
    import torch  # noqa: F401
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import cost_analysis as CA
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    by_op = defaultdict(float)
    count_op, count_kernel = CA.op_cost, CA.kernel_cost

    def op_cost(func, args, kwargs, out, costs):
        before = costs.flops
        count_op(func, args, kwargs, out, costs)
        if costs.flops != before:
            by_op[func.overloadpacket.__name__] += costs.flops - before

    def kernel_cost(name, flops, nbytes_, dtype=None):
        by_op[name] += flops
        count_kernel(name, flops, nbytes_, dtype)

    CA.op_cost, CA.kernel_cost = op_cost, kernel_cost
    import repro_torch.kernels.common  # noqa: F401  (the wrappers' import)
    for mod in list(sys.modules.values()):
        if getattr(mod, "kernel_cost", None) is count_kernel:
            mod.kernel_cost = kernel_cost
    try:
        c = dryrun.mesh_count(cfg, ShapeConfig(*SHAPE),
                              AbstractMesh(("pod", "data", "model"),
                                           (2, 2, 2)),
                              moe_groups=groups)
    finally:
        CA.op_cost, CA.kernel_cost = count_op, count_kernel
        for mod in list(sys.modules.values()):
            if getattr(mod, "kernel_cost", None) is kernel_cost:
                mod.kernel_cost = count_kernel
    return {"flops": c["costs"].flops,
            "by_category": dict(c["costs"].flops_by),
            "by_op": dict(sorted(by_op.items(), key=lambda kv: -kv[1]))}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=list(CONFIGS), default="dense")
    ap.add_argument("--moe-groups", type=int, default=1)
    args = ap.parse_args()
    from repro_torch.configs.base import ModelConfig
    conf = CONFIGS[args.config]
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    ref = subprocess.run([sys.executable, "-c", REF, json.dumps(conf),
                          json.dumps(list(SHAPE)), str(args.moe_groups)],
                         env=env, capture_output=True, text=True, check=True)
    ref = json.loads(next(ln for ln in ref.stdout.splitlines()
                          if ln.startswith("REF "))[4:])
    port = port_split(ModelConfig(**conf), args.moe_groups)
    print(json.dumps({"config": args.config, "moe_groups": args.moe_groups,
                      "ratio": port["flops"] / ref["flops"], "port": port,
                      "reference": ref, "cfg": conf}))


if __name__ == "__main__":
    main()
