"""The port's kernel build keys and the kernel comparison script, on a
machine without a card or ``nvcc``."""

import shutil

import torch

from kubeflow_tpu_torch.ops import _build, compare_fwd
from kubeflow_tpu_torch.ops import flash_attention as fa


def test_each_source_directory_keys_its_library_by_the_bytes(tmp_path):
    other = tmp_path / "csrc"
    other.mkdir()
    shutil.copy(_build.CSRC / fa.SOURCE, other / fa.SOURCE)
    plain = _build.library_path(fa.SOURCE)
    # The same bytes from another directory are the same library ...
    assert _build.library_path(fa.SOURCE, other) == plain
    # ... edited bytes are not.
    (other / fa.SOURCE).write_text((other / fa.SOURCE).read_text() + "\n")
    edited = _build.library_path(fa.SOURCE, other)
    assert edited != plain
    assert all(p.parent == _build.BUILD_DIR and p.suffix == ".so"
               for p in (plain, edited))


def test_build_of_nothing_compiles_nothing():
    assert _build.build([]) == []


def test_compare_script_needs_a_card(capsys):
    if torch.cuda.is_available():
        return
    assert compare_fwd.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
