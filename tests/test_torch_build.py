"""The port's kernel build keys and the kernel comparison script, on a
machine without a card or ``nvcc``."""

import shutil

import torch

from kubeflow_tpu_torch.ops import _build, compare
from kubeflow_tpu_torch.ops import flash_attention as fa


def test_each_source_directory_keys_its_library_by_the_bytes(tmp_path):
    other = tmp_path / "csrc"
    other.mkdir()
    for path in _build.CSRC.iterdir():
        shutil.copy(path, other / path.name)
    headers = sorted(other.glob("*.cuh"))
    assert headers, "the sources share a header"
    plain = {src: _build.library_path(src) for src in _build.sources()}
    # The same bytes from another directory are the same library ...
    assert {src: _build.library_path(src, other) for src in plain} == plain
    # ... an edited header (which both sources include) is not ...
    headers[0].write_text(headers[0].read_text() + "\n")
    edited = {src: _build.library_path(src, other) for src in plain}
    assert all(edited[src] != plain[src] for src in plain)
    # ... and nor is an edited source.
    (other / fa.SOURCE).write_text((other / fa.SOURCE).read_text() + "\n")
    assert _build.library_path(fa.SOURCE, other) != edited[fa.SOURCE]
    assert _build.library_path(fa.BWD_SOURCE, other) == edited[fa.BWD_SOURCE]
    assert all(p.parent == _build.BUILD_DIR and p.suffix == ".so"
               for p in [*plain.values(), *edited.values()])


def test_build_of_nothing_compiles_nothing():
    assert _build.build([]) == []


def test_compare_script_needs_a_card(capsys):
    if torch.cuda.is_available():
        return
    assert compare.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
