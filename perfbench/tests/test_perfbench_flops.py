"""The yardstick's counts against values worked out by hand."""

import pytest

from perfbench import cells, flops

H100 = flops.peaks_for("NVIDIA H100 80GB HBM3")


def test_peaks_by_card_name():
    assert H100 == flops.Peaks(989e12, 67e12, 3.35e12)
    assert flops.peaks_for("NVIDIA H100 PCIe").bf16_flops == 756e12
    assert flops.peaks_for("NVIDIA A100-SXM4-80GB") is None


@pytest.mark.parametrize("cell, want", [
    # 3 x (8 * 1024 * (48 * (2*1600*4800 + 2*1600^2 + 4*1600*6400)
    #                  + 2*1600*50257) + 48 * 2*8*1024^2*1600)
    ("gpt2-xl.fit", 3 * (8 * 1024 * (48 * 61_440_000 + 160_822_400)
                         + 48 * 26_843_545_600)),
    # 3 x (16384 * (24 * (2*2048*6144 + 2*2048^2 + 4*2048*8192)
    #               + 2*2048*50257) + 24 * 2*16384^2*2048)
    ("cerebras-gpt-1.3b.long16k",
     3 * (16384 * (24 * 100_663_296 + 205_852_672)
          + 24 * 1_099_511_627_776)),
    ("cerebras-gpt-1.3b.fit",
     3 * (16384 * (24 * 100_663_296 + 205_852_672)
          + 24 * 137_438_953_472)),
])
def test_train_step_flops(cell, want):
    c = cells.load_cell(cell)
    assert flops.train_step_flops(c.model, c.batch) == want


def test_train_step_flops_magnitudes():
    # The issue's reckoning: 8.03e13 (GPT-2 XL), 2.08e14 (16k), 1.39e14.
    got = {name: flops.train_step_flops(cells.load_cell(name).model,
                                        cells.load_cell(name).batch)
           for name in ("gpt2-xl.fit", "cerebras-gpt-1.3b.long16k",
                        "cerebras-gpt-1.3b.fit")}
    assert got["gpt2-xl.fit"] == pytest.approx(8.03e13, rel=2e-3)
    assert got["cerebras-gpt-1.3b.long16k"] == pytest.approx(2.08e14,
                                                             rel=2e-3)
    assert got["cerebras-gpt-1.3b.fit"] == pytest.approx(1.39e14, rel=2e-3)


def test_attention_bounds_by_hand():
    # GPT-2 XL's forward call: [8, 1024, 25, 64] bf16, causal.
    ms, by, ops = flops.attention_bound_ms((8, 1024, 25, 64), "bfloat16",
                                           True, H100)
    assert ops == 4 * 8 * 25 * (1024 * 1025 // 2) * 64
    nbytes = 4 * 8 * 1024 * 25 * 64 * 2 + 8 * 25 * 1024 * 4
    # 105.7 MB in 31.5 us against 2.69e10 products in 27.2 us.
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert by == "bytes"
    # The 16k cell's dQ and dK/dV calls: [1, 16384, 16, 128].
    pairs = 16384 * 16385 // 2
    for kernel, products in (("dq", 3), ("dkv", 4)):
        ms, by, ops = flops.bwd_bound_ms((1, 16384, 16, 128), "bfloat16",
                                         True, kernel, H100)
        assert ops == products * 2 * 16 * pairs * 128
        assert by == "operations"
        assert ms == pytest.approx(ops / 989e12 * 1e3)
    # dQ's bytes: six [b, s, h, d] tensors and two f32 rows.
    _, by, _ = flops.bwd_bound_ms((64, 128, 1, 8), "bfloat16", True, "dq",
                                  H100)
    assert by == "bytes"


def test_attention_shape_is_a_microbatch():
    assert cells.load_cell("cerebras-gpt-1.3b.fit").attention_shape == \
        (4, 2048, 16, 128)
    assert cells.load_cell("gpt2-xl.fit").attention_shape == \
        (8, 1024, 25, 64)
    assert cells.load_cell("cerebras-gpt-1.3b.long16k").attention_shape == \
        (1, 16384, 16, 128)
