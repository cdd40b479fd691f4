"""How the port's CUDA kernels are named and refused without a card, on the
CPU: a library is named by a hash of its source, the shared headers it may
include and the flags, so an edited header is never loaded stale; and the
device check names every kernel it guards."""

import shutil

import pytest

torch = pytest.importorskip("torch")

from repro_torch import device as D  # noqa: E402
from repro_torch.kernels import build  # noqa: E402


@pytest.fixture
def csrc(tmp_path):
    """A copy of the kernels' sources that a test may edit."""
    dst = tmp_path / "csrc"
    shutil.copytree(build.CSRC, dst)
    return dst


def test_the_kernels_share_a_header():
    assert sorted(p.name for p in build.CSRC.glob("*.cuh")), \
        "the tensor-core kernels share a header of PTX wrappers"
    assert set(build.SIGNATURES) == {p.name for p in build.CSRC.glob("*.cu")}


@pytest.mark.parametrize("source", sorted(build.SIGNATURES))
def test_library_path_changes_with_a_header(csrc, source):
    before = build.library_path(source, csrc)
    assert build.library_path(source, build.CSRC) == before  # same bytes
    header = sorted(csrc.glob("*.cuh"))[0]
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = build.library_path(source, csrc)
    assert after != before
    assert after.parent == before.parent == build.BUILD_DIR
    assert after.name.startswith(source.rsplit(".", 1)[0] + "-")


def test_library_path_changes_with_its_source_only(csrc):
    paths = {s: build.library_path(s, csrc) for s in build.SIGNATURES}
    src = csrc / "ssd_scan.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    for s, p in paths.items():
        assert (build.library_path(s, csrc) != p) == (s == "ssd_scan.cu")


def test_a_new_header_changes_every_library_path(csrc):
    paths = {s: build.library_path(s, csrc) for s in build.SIGNATURES}
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert all(build.library_path(s, csrc) != p for s, p in paths.items())


def test_a_card_that_is_not_hopper_is_refused_naming_every_kernel(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda dev=None: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA A100")
    with pytest.raises(RuntimeError) as e:
        D.resolve_device("cuda")
    msg = str(e.value)
    for kernel in ("event loop", "rmsnorm", "flash attention", "SSD scan"):
        assert kernel in msg
    assert "sm_90a" in msg and "event-loop kernels need" not in msg
