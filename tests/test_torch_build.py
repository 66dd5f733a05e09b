"""The port's kernel build names each library by a hash of everything that
goes into it: every file under the source's csrc/ (the .cu files and the
headers they include) and the nvcc flags, include paths among them. No
nvcc is needed: only the names are computed."""
import shutil
from pathlib import Path

import pytest

from repro_torch.kernels import build


@pytest.fixture
def tree(tmp_path):
    """A copy of the flash-attention sources under tmp_path."""
    src = Path(build.SOURCES["flash_attention_wgmma"]).parent
    dst = tmp_path / "flash_attention" / "csrc"
    shutil.copytree(src, dst)
    return {"k": dst / "flash_attention_wgmma.cu"}


def test_header_edit_changes_library_path(tree):
    before = build.library_path("k", tree)
    assert before == build.library_path("k", tree)
    header = tree["k"].parent / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = build.library_path("k", tree)
    assert after != before
    assert after.parent == build.BUILD_DIR
    assert after.name.startswith("libk-") and after.suffix == ".so"


def test_new_file_and_flags_change_library_path(tree):
    before = build.library_path("k", tree)
    for extra in ("-lineinfo", "-Ithird_party/include"):
        assert build.library_path(
            "k", tree, flags=(*build.NVCC_FLAGS, extra)) != before
    (tree["k"].parent / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path("k", tree) != before


def test_files_outside_csrc_do_not_change_library_path(tree):
    before = build.library_path("k", tree)
    (tree["k"].parents[1] / "notes.txt").write_text("not a source\n")
    assert build.library_path("k", tree) == before


def test_every_source_is_a_cu_file_in_a_csrc_dir():
    for name, path in build.SOURCES.items():
        assert path.suffix == ".cu" and path.parent.name == "csrc", name
        assert path.exists(), path
        assert build.library_path(name).name.startswith(f"lib{name}-")


def test_source_flags_extend_only_their_source():
    """A source's own flags (the CUDA-core flash backward's split
    compilation) follow the shared ones, enter its library's hash, and
    leave every other source's flags as they are."""
    bwd = build.flags_of("flash_attention_bwd")
    assert bwd[:len(build.NVCC_FLAGS)] == build.NVCC_FLAGS
    assert "--split-compile=0" in bwd[len(build.NVCC_FLAGS):]
    for name in build.SOURCES:
        if name != "flash_attention_bwd":
            assert build.flags_of(name) == build.NVCC_FLAGS
    assert build.library_path("flash_attention_bwd") != build.library_path(
        "flash_attention_bwd", flags=build.NVCC_FLAGS)
