"""The kernel build's library name: a hash of the ``.cu`` source and of
every header it includes with ``#include "..."``, so that a changed
shared header never loads a stale library. No ``nvcc`` is needed."""
import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (src / "kern.cu").write_text(
        '#include <cuda_runtime.h>\n#include "shared.cuh"\n'
        'extern "C" int kern_launch() { return helper(); }\n')
    (src / "shared.cuh").write_text(
        '#pragma once\n#include "inner.cuh"\n'
        'inline int helper() { return inner(); }\n')
    (src / "inner.cuh").write_text("inline int inner() { return 0; }\n")
    (src / "unrelated.cuh").write_text("inline int other() { return 1; }\n")
    return src


def test_library_path_is_stable_and_lives_in_the_build_dir(csrc):
    path = _build.library_path("kern")
    assert path == _build.library_path("kern")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libkern-") and path.suffix == ".so"


@pytest.mark.parametrize("edited", ["kern.cu", "shared.cuh", "inner.cuh"])
def test_library_path_follows_the_source_and_its_headers(csrc, edited):
    before = _build.library_path("kern")
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    assert _build.library_path("kern") != before


def test_library_path_ignores_headers_it_does_not_include(csrc):
    before = _build.library_path("kern")
    (csrc / "unrelated.cuh").write_text("inline int other() { return 2; }\n")
    (csrc / "new.cuh").write_text("inline int fresh() { return 3; }\n")
    assert _build.library_path("kern") == before


def test_every_port_kernel_hashes_its_shared_header():
    # the forward's long-sequence instance uses the wgmma / TMA helpers
    names = {p.name for p in _build._source_files(
        (_build.CSRC / "flash_attention.cu").resolve(), [])}
    assert names == {"flash_attention.cu", "tensor_core.cuh", "wgmma.cuh"}
    # and so does the decode's TMA instance
    names = {p.name for p in _build._source_files(
        (_build.CSRC / "flash_decode.cu").resolve(), [])}
    assert names == {"flash_decode.cu", "tensor_core.cuh", "wgmma.cuh"}


def test_backward_kernel_hashes_both_headers():
    """The attention backward includes the mma.sync helpers and the
    wgmma / TMA / mbarrier helpers: an edit to either rebuilds it."""
    names = {p.name for p in _build._source_files(
        (_build.CSRC / "flash_attention_bwd.cu").resolve(), [])}
    assert names == {"flash_attention_bwd.cu", "tensor_core.cuh",
                     "wgmma.cuh"}
