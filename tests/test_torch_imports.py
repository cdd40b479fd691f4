"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the reference package ``repro`` (nor
``ml_dtypes``, which the card's machine may lack), and the port's entry
points run on the card unless asked for the CPU."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _module(path: pathlib.Path) -> str:
    parts = path.relative_to(PORT.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


MODULES = sorted(_module(p) for p in PORT.rglob("*.py"))
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
#: the serving slice's modules, which the checks below must reach
SERVING_SLICE = {
    "repro_torch.configs", "repro_torch.configs.base",
    "repro_torch.configs.zamba2_7b", "repro_torch.models",
    "repro_torch.models.layers", "repro_torch.models.ssm",
    "repro_torch.models.model", "repro_torch.models.decode",
    "repro_torch.data", "repro_torch.data.pipeline",
    "repro_torch.serving", "repro_torch.serving.engine",
    "repro_torch.launch", "repro_torch.launch.serve",
    "repro_torch.kernels.common", "repro_torch.kernels.rmsnorm",
    "repro_torch.kernels.flash_attention", "repro_torch.kernels.ssd_scan",
    "repro_torch.convert", "repro_torch.core.metrics",
}
#: the selection-policy slice's modules
POLICY_SLICE = {
    "repro_torch.core", "repro_torch.core.rewards", "repro_torch.core.api",
    "repro_torch.core.agents", "repro_torch.core.fuzzy",
    "repro_torch.core.drift", "repro_torch.core.selectors",
    "repro_torch.core.simpolicy", "repro_torch.core.learned",
    "repro_torch.core.persistence", "repro_torch.core.service",
    "repro_torch.sim", "repro_torch.sim.whatif", "repro_torch.sim.translog",
    "repro_torch.sim.campaign",
}
#: the perturbation / Python-engine slice's modules
ENGINE_SLICE = {
    "repro_torch.sim.perturb", "repro_torch.sim.backends.python",
    "repro_torch.sim.engine", "repro_torch.sim.engine_torch",
}
#: the serving dispatcher and fleet slice's modules
FLEET_SLICE = {
    "repro_torch.serving.fleet", "repro_torch.serving.fleet.traces",
    "repro_torch.serving.fleet.recovery", "repro_torch.serving.fleet.journal",
    "repro_torch.serving.fleet.router", "repro_torch.serving.fleet.simulator",
}

#: the async-dispatch / lane-split and learned-selection training slice
TRAINING_SLICE = {
    "repro_torch.launch.mesh", "repro_torch.distributed",
    "repro_torch.distributed.sharding", "repro_torch.optim",
    "repro_torch.optim.adamw", "repro_torch.checkpoint",
    "repro_torch.checkpoint.manager", "repro_torch.runtime",
    "repro_torch.runtime.trainer", "repro_torch.runtime.policy_trainer",
}
#: the dense-training slice: the llama config, the train step, the
#: step-plan autotuner, gradient compression and the launcher
DENSE_TRAIN_SLICE = {
    "repro_torch.configs.llama3_2_3b", "repro_torch.launch.steps",
    "repro_torch.launch.train", "repro_torch.distributed.autotune",
    "repro_torch.distributed.compression",
}

#: the dense, VL and MoE serving slice: the configs and the flags
FAMILIES_SLICE = {
    "repro_torch.configs.granite_8b", "repro_torch.configs.mistral_nemo_12b",
    "repro_torch.configs.qwen3_32b", "repro_torch.configs.qwen2_vl_72b",
    "repro_torch.configs.olmoe_1b_7b", "repro_torch.configs.grok_1_314b",
    "repro_torch.distributed.ctx",
}
#: the SSM and enc-dec serving slice: their configs
SSM_ENCDEC_SLICE = {
    "repro_torch.configs.mamba2_2p7b", "repro_torch.configs.whisper_small",
}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")])
    return env


def test_every_port_module_imports_without_jax_or_repro():
    code = (
        "import importlib, json, sys\n"
        f"mods = {MODULES!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'repro', 'ml_dtypes'))\n"
        "print(json.dumps({'n': len(mods), 'bad': bad}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=240)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["n"] == len(MODULES) >= 69
    assert SERVING_SLICE <= set(MODULES)
    assert POLICY_SLICE <= set(MODULES)
    assert ENGINE_SLICE <= set(MODULES)
    assert FLEET_SLICE <= set(MODULES)
    assert TRAINING_SLICE <= set(MODULES)
    assert DENSE_TRAIN_SLICE <= set(MODULES)
    assert FAMILIES_SLICE <= set(MODULES)
    assert SSM_ENCDEC_SLICE <= set(MODULES)
    assert rec["bad"] == []


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax_or_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:          # relative: stays inside the port
                continue
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
                (path, n)


def test_every_kernel_source_has_an_entry_point_signature():
    from repro_torch.kernels import build
    sources = {p.name for p in (PORT / "kernels" / "csrc").glob("*.cu")}
    assert sources == set(build.SIGNATURES) == {
        "event_loop.cu", "rmsnorm.cu", "flash_attention.cu",
        "flash_attention_bwd.cu", "ssd_scan.cu", "ssd_scan_bwd.cu"}


def test_backend_defaults_to_the_card():
    from repro_torch import TorchBatchedBackend, resolve_device
    if torch.cuda.is_available():
        assert TorchBatchedBackend().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBatchedBackend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert TorchBatchedBackend(device="cpu").device.type == "cpu"


def test_unknown_event_core_and_device_are_refused():
    from repro_torch import TorchBatchedBackend
    with pytest.raises(ValueError, match="unknown event core"):
        TorchBatchedBackend(device="cpu", event_core="auto")
    with pytest.raises(ValueError, match="unsupported device"):
        TorchBatchedBackend(device="meta")


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=240,
                         env=_env())
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone in a directory, without the checkout around it, it fails too
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, timeout=240, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_training_entry_points_default_to_the_card():
    """The trainer and the launcher run on the card unless asked for the
    CPU; without a card they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import get_config, smoke_reduce
    from repro_torch.data import DataConfig
    from repro_torch.distributed import make_plan_builder
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    cfg = smoke_reduce(get_config("llama3.2-3b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, AdamWConfig(), DataConfig(512, 8, 2),
                TrainerConfig(ckpt_dir="unused"), step_fn=lambda *a: a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_plan_builder(cfg, AdamWConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "whisper-small"])
def test_ssm_and_encdec_serving_defaults_to_the_card(arch):
    """``init_params``, ``init_decode_cache``, ``live`` and the serve
    launcher run the SSM and enc-dec families on the card unless asked for
    the CPU; without a card they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import get_config, smoke_reduce
    from repro_torch.launch import serve
    from repro_torch.models import init_decode_cache, init_params
    cfg = smoke_reduce(get_config(arch))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_decode_cache(cfg, 2, 8)
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.live(cfg, params, slots=2, max_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", arch])
