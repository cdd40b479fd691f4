"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the reference package ``repro``, and the
port's entry points run on the card unless asked for the CPU."""

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
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps({'n': len(mods), 'bad': bad}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=240)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["n"] == len(MODULES) >= 16
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
            assert top not in ("jax", "jaxlib", "repro"), (path, n)


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
