"""The port's kernel build keys and the kernel comparison script, on a
machine without a card or ``nvcc``."""

import ctypes
import re
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


def test_ptxas_notes_keep_each_bf16_kernels_registers_spills_and_c75xx():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_119wide_dq_bf16_kernelILi256EEEv14CUtensorMap_st'"
        " for 'sm_90a'",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_114wide_dq_kernelIfEEvNS_6ParamsE' for 'sm_90a'",
        "ptxas info    : Used 40 registers",
        "ptxas /tmp/x.ptx, line 9; warning : (C7518) Potential Performance "
        "Loss: wgmma.mma_async instructions are serialized",
    ])
    assert compare.ptxas_notes(log) == [
        "wide_dq_bf16_kernel<256>: ptxas info    : Used 168 registers, "
        "used 1 barriers",
        "wide_dq_bf16_kernel<256>: 0 bytes stack frame, 0 bytes spill "
        "stores, 0 bytes spill loads",
        "ptxas /tmp/x.ptx, line 9; warning : (C7518) Potential Performance "
        "Loss: wgmma.mma_async instructions are serialized"]


def test_sass_counts_by_library_and_by_kernel():
    sass = "\n".join([
        "\t\tFunction : _Z19wide_dq_bf16_kernelILi256EEv",
        "        /*0000*/                   UTMALDG.4D [UR8], [UR4] ;",
        "        /*0010*/               @P0 HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24 ;",
        "        /*0020*/                   HGMMA.64x256x16.F32.BF16 R88, R20, gdesc[UR12], R88 ;",
        "\t\tFunction : _Z14wide_dq_kernelIfEv",
        "        /*0000*/                   FFMA R1, R2, R3, R1 ;",
    ])
    assert compare.count_sass(sass) == {"HGMMA": 2, "UTMALDG": 1, "HMMA": 0}
    assert compare.count_sass(sass, by_kernel=True) == {
        "_Z19wide_dq_bf16_kernelILi256EEv":
            {"HGMMA": 2, "UTMALDG": 1, "HMMA": 0}}


class _UntypedLibrary:
    """Stands in for a loaded library: each entry point an untyped
    function object, the same one on every access."""

    def __getattr__(self, name):
        fn = type("Entry", (), {"argtypes": None, "restype": None})()
        setattr(self, name, fn)
        return fn


def _c_parameters(source: str) -> dict:
    """The ctypes type of each parameter of each ``extern "C"`` entry
    point of a source: pointers as ``c_void_p`` (the stride array as a
    pointer to ``c_longlong``), the scalars as their own types."""
    text = (_build.CSRC / source).read_text()
    entries = {}
    for name, params in re.findall(
            r'extern "C" [^(]*?\b(kftpu_\w+)\((.*?)\)\s*\{', text, re.S):
        types = []
        for param in params.split(","):
            kind = param.strip().rsplit(None, 1)[0]
            types.append(ctypes.POINTER(ctypes.c_longlong)
                         if kind == "const long long*"
                         else ctypes.c_void_p if kind.endswith("*")
                         else {"int": ctypes.c_int,
                               "long long": ctypes.c_longlong,
                               "float": ctypes.c_float}[kind])
        entries[name] = types
    return entries


def test_ctypes_signatures_match_the_c_entry_points():
    # A wrong argtypes list passes ints where pointers go, or raises on
    # every launch: hold each typed entry point to the source's signature.
    for typed, source in ((fa._library, fa.SOURCE),
                          (fa._bwd_library, fa.BWD_SOURCE),
                          (fa._wide_library, fa.WIDE_SOURCE)):
        lib = typed(_UntypedLibrary())
        entries = _c_parameters(source)
        checked = [name for name in entries
                   if getattr(lib, name).argtypes is not None]
        assert any(name.startswith("kftpu_") for name in checked), source
        for name in checked:
            assert list(getattr(lib, name).argtypes) == entries[name], name
