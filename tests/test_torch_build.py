"""The port's kernel build: where a library lives for its sources.

A library's file name carries a hash of its ``csrc/<name>.cu``, of every
shared header ``csrc/*.cuh`` and of the flags, so that an edited source or
header is rebuilt and a stale library is never loaded. These run on the
CPU: they compute paths and compile nothing.
"""

import pytest

from speech_recognition_tpu_torch.ops.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "kern.cu").write_text('#include "common.cuh"\nint k;\n')
    (src / "other.cu").write_text("int o;\n")
    (src / "common.cuh").write_text("#pragma once\nint c;\n")
    monkeypatch.setattr(build, "CSRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return src


def test_library_path_is_stable_for_unchanged_sources(csrc):
    path = build.library_path("kern")
    assert path == build.library_path("kern")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libkern-") and path.suffix == ".so"
    assert path != build.library_path("other")


@pytest.mark.parametrize("edit", ["header", "new_header", "source"])
def test_editing_a_source_or_a_header_changes_the_path(csrc, edit):
    before = build.library_path("kern")
    if edit == "header":
        (csrc / "common.cuh").write_text("#pragma once\nint c = 1;\n")
    elif edit == "new_header":
        (csrc / "more.cuh").write_text("#pragma once\n")
    else:
        (csrc / "kern.cu").write_text('#include "common.cuh"\nint k = 1;\n')
    assert build.library_path("kern") != before


def test_files_that_are_no_source_or_header_do_not_change_the_path(csrc):
    before = build.library_path("kern")
    (csrc / "notes.txt").write_text("not compiled\n")
    (csrc / "other.cu").write_text("int o = 2;\n")
    assert build.library_path("kern") == before


def test_the_repository_sources_include_the_shared_header():
    """Both separable-block sources take their shared device code from
    ``separable_common.cuh``, which the hash covers."""
    common = build.CSRC_DIR / "separable_common.cuh"
    assert common.exists()
    for name in ("separable_block", "separable_block_bwd"):
        text = (build.CSRC_DIR / f"{name}.cu").read_text()
        assert '#include "separable_common.cuh"' in text
        assert "struct Pair" not in text and "mma_bf16(" not in text
