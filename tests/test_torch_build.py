"""The port's kernel build keys and the kernel comparison script, on a
machine without a card or ``nvcc``."""

import ctypes
import re
import shutil

import pytest
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


def test_the_library_key_holds_the_toolkit(monkeypatch, tmp_path):
    """A library seeded from another nvcc is another library: the key
    hashes ``nvcc --version``, read once a process, and an empty string
    where no nvcc is found, so the name still resolves."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!/bin/sh\necho x >> {calls}\n"
                    "echo 'Cuda compilation tools, release 12.8, V12.8.93'\n")
    fake.chmod(0o755)
    try:
        _build.toolkit.cache_clear()
        monkeypatch.setattr(_build, "_nvcc", no_nvcc)
        assert _build.toolkit() == ""
        bare = _build.library_path(fa.SOURCE)
        _build.toolkit.cache_clear()
        monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
        assert "release 12.8" in _build.toolkit()
        assert "release 12.8" in _build.toolkit()
        assert calls.read_text() == "x\n"  # once a process
        with_12_8 = _build.library_path(fa.SOURCE)
        _build.toolkit.cache_clear()
        fake.write_text("#!/bin/sh\necho 'release 12.9, V12.9.41'\n")
        with_12_9 = _build.library_path(fa.SOURCE)
    finally:
        _build.toolkit.cache_clear()
    assert len({bare, with_12_8, with_12_9}) == 3
    assert bare.parent == with_12_8.parent == _build.BUILD_DIR
    assert bare.name.startswith("flash_attention_fwd-")


def test_the_library_dir_moves_and_keys_each_load(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    before = _build.library_path(fa.SOURCE)
    assert _build.set_library_dir(tmp_path) == before.parent
    assert _build.library_path(fa.SOURCE) == tmp_path / before.name


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


@pytest.mark.parametrize("mangled,name", [
    ("_ZN5kftpu6f32fwd20fwd_f32_tiled_kernelILi64ELb0EEEv14CUtensorMap_st"
     "S2_S2_NS0_6ParamsE", "fwd_f32_tiled_kernel<64, false>"),
    ("_ZN55_GLOBAL__N__038de090_22_flash_attention_fwd_cu_846ea7076f32fwd20"
     "fwd_f32_tiled_kernelILi256ELb1EEEv14CUtensorMap_stS2_S2_NS1_6ParamsE",
     "fwd_f32_tiled_kernel<256, true>"),
    ("_ZN56_GLOBAL__N__d2dbf473_23_flash_attention_wide_cu_5734265b27wide_"
     "fwd_bf16_sliced_kernelE14CUtensorMap_stS0_S0_NS_6ParamsE",
     "wide_fwd_bf16_sliced_kernel"),
    ("_ZN12_GLOBAL__N_119wide_dq_bf16_kernelILi192EEEv14CUtensorMap_st",
     "wide_dq_bf16_kernel<192>"),
    ("_ZN55_GLOBAL__N__038de090_22_flash_attention_bwd_cu_846ea7076f32bwd19"
     "dq_f32_tiled_kernelILi128EEEv14CUtensorMap_stS2_S2_S2_NS1_6ParamsE",
     "dq_f32_tiled_kernel<128>"),
    ("_ZN56_GLOBAL__N__d2dbf473_23_flash_attention_wide_cu_5734265b6f32bwd20"
     "dkv_f32_tiled_kernelILi256EEEv14CUtensorMap_stS2_S2_S2_NS1_6ParamsE",
     "dkv_f32_tiled_kernel<256>"),
    ("_ZN56_GLOBAL__N__d2dbf473_23_flash_attention_wide_cu_5734265b26wide_"
     "dq_bf16_sliced_kernelE14CUtensorMap_stS0_S0_S0_NS_6ParamsE",
     "wide_dq_bf16_sliced_kernel"),
    ("_ZN56_GLOBAL__N__d2dbf473_23_flash_attention_wide_cu_5734265b27wide_"
     "dkv_bf16_sliced_kernelE14CUtensorMap_stS0_S0_S0_NS_6ParamsE",
     "wide_dkv_bf16_sliced_kernel"),
    ("_Z19encode_tensor_helperP14CUtensorMap_stPKv", None),
])
def test_ptxas_notes_name_the_redesigned_kernels(mangled, name):
    # The f32 forward and backward and the sliced bf16 kernels are named in
    # ptxas's notes beside the wgmma kernels; a function that is no kernel
    # of the port is not.
    line = f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'"
    assert compare._kernel_name(line) == name
    notes = compare.ptxas_notes(
        line + "\nptxas info    : Used 168 registers, used 1 barriers")
    assert notes == ([] if name is None else [
        f"{name}: ptxas info    : Used 168 registers, used 1 barriers"])


def test_compare_cases_time_the_redesigned_forward_routes():
    # f32 at d 32, 128 and 256 and bf16 at d 320, the forward and the
    # partial each, at the shape that fills the card and at [1, 1024, 8, d].
    cases = {c[0]: c[1:] for c in compare.CASES}
    for dtype, tag, dims in (("float32", "f32", (32, 128, 256)),
                             ("bfloat16", "bf16", (320,))):
        for d in dims:
            for kernel, offsets in (("fwd", None), ("partial", (0, 0))):
                assert cases[f"{kernel}_{tag}_d{d}"] == (
                    kernel, (8, 1024, 16, d), offsets, dtype)
                assert cases[f"{kernel}_{tag}_d{d}_small"] == (
                    kernel, (1, 1024, 8, d), offsets, dtype)
    assert all(len(c) == 5 for c in compare.CASES)


def test_compare_cases_time_the_f32_backward_pair():
    # dQ (computing delta) and dK/dV in f32 at d 32, 128 and 256, at the
    # shape that fills the card and at [1, 1024, 8, d].
    cases = {c[0]: c[1:] for c in compare.CASES}
    for d in (32, 128, 256):
        assert cases[f"bwd_f32_d{d}"] == ("bwd", (8, 1024, 16, d), None,
                                          "float32")
        assert cases[f"bwd_f32_d{d}_small"] == ("bwd", (1, 1024, 8, d),
                                                None, "float32")
    assert len({c[0] for c in compare.CASES}) == len(compare.CASES)


def test_compare_cases_time_the_sliced_bf16_backward_pair():
    # dQ (computing delta) and dK/dV in bf16 at d 320 (two 256-column
    # slices), at the shape that fills the card and at [1, 1024, 8, d].
    cases = {c[0]: c[1:] for c in compare.CASES}
    assert cases["bwd_bf16_d320"] == ("bwd", (8, 1024, 16, 320), None,
                                      "bfloat16")
    assert cases["bwd_bf16_d320_small"] == ("bwd", (1, 1024, 8, 320), None,
                                            "bfloat16")
    assert len({c[0] for c in compare.CASES}) == len(compare.CASES)


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
