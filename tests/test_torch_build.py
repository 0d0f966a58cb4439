"""The one build of the port's CUDA sources (troy_tpu_torch/ops/_cuda_build.py):
every csrc/*.cu goes into one library whose name hashes every source and
header, so an edit to a shared header cannot be served by a stale build."""

import shutil

from troy_tpu_torch.ops import _cuda_build


def test_every_kernel_source_is_built():
    names = {p.name for p in _cuda_build.sources()}
    assert {"ntt.cu", "bconv.cu", "fused_mul.cu"} <= names


def test_digest_covers_sources_and_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda_build.CSRC, csrc)
    base = _cuda_build.digest(csrc)
    assert base == _cuda_build.digest(_cuda_build.CSRC)
    for name in ("ntt_common.cuh", "bconv.cu", "ntt.cu"):
        path = csrc / name
        text = path.read_text()
        path.write_text(text + "\n// edited\n")
        assert _cuda_build.digest(csrc) != base, name
        path.write_text(text)
    assert _cuda_build.digest(csrc) == base
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _cuda_build.digest(csrc) != base


def test_library_lives_in_the_build_directory():
    lib = _cuda_build.library_path()
    assert lib.parent == _cuda_build.BUILD_DIR
    assert _cuda_build.digest() in lib.name
