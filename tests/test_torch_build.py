"""The kernel build's cache key: `ops/build.py::library_path` names a
library by a hash of its `csrc/<name>.cu` and every shared `csrc/*.cuh`, so
an edit to either rebuilds it and a stale library is never loaded. Runs on
the CPU: nothing here calls nvcc."""

import re
import shutil

import pytest

from labelany3d_tpu_torch.ops import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of `csrc/` in a tmp directory, with the build pointed at it."""
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC, src)
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    return src


def test_library_path_is_stable_when_nothing_changes(csrc):
    for name in ("packed_attention", "flash_attention", "nn_argmax", "yaw_minarea"):
        assert build.library_path(name) == build.library_path(name)
        assert build.library_path(name).parent == build.BUILD_DIR


@pytest.mark.parametrize("name", ["packed_attention", "flash_attention", "nn_argmax"])
def test_library_path_changes_with_a_shared_header(csrc, name):
    before = build.library_path(name)
    header = csrc / "attention_sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.library_path(name) != before


def test_library_path_changes_with_a_new_header(csrc):
    before = build.library_path("yaw_minarea")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path("yaw_minarea") != before


def test_library_path_changes_with_its_own_source_only(csrc):
    k1, k2 = build.library_path("packed_attention"), build.library_path("flash_attention")
    src = csrc / "packed_attention.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert build.library_path("packed_attention") != k1
    assert build.library_path("flash_attention") == k2


def test_build_all_compiles_only_the_cu_sources(csrc, monkeypatch):
    built = []
    monkeypatch.setattr(build, "build", lambda name, verbose=False: built.append(name) or "")
    logs = build.build_all()
    want = sorted(p.stem for p in csrc.glob("*.cu"))
    assert sorted(built) == want == sorted(logs)
    assert "attention_sm90" not in built


def test_every_included_header_is_in_csrc():
    """The hash covers `csrc/*.cuh`; a kernel that included a header from
    elsewhere would escape it."""
    for src in build.CSRC.glob("*.cu"):
        for header in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            assert (build.CSRC / header).exists(), (src.name, header)
            assert header.endswith(".cuh")
