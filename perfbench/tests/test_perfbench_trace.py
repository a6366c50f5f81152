"""The trace reader and the per-layer metric readers, on a trace written
by hand: which kernel is whose, the union of the device's intervals, the
idle gaps and what each reader makes of them."""

import pytest

from perfbench import cells, flops
from perfbench.harness import TracedRun
from perfbench.trace import Trace, optimizer_kernels

H100 = flops.peaks_for("NVIDIA H100 80GB HBM3")


def _x(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "tid": tid}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _events(with_optimizer_range=True):
    host = [_x("user_annotation", "perfbench.step", 0, 1000),
            _x("cpu_op", "aten::mm", 10, 40),
            _x("cpu_op", "FlashAttention", 28, 15),
            _x("cpu_op", "aten::_foreach_add_", 700, 100)]
    if with_optimizer_range:
        host.append(_x("user_annotation", "perfbench.optimizer", 600, 300))
    # The dK/dV kernel is launched from the backward's own thread.
    launches = [_x("cuda_runtime", "cudaLaunchKernel", ts, 2,
                   tid=2 if c == 3 else 1, corr=c)
                for c, ts in ((1, 20), (2, 30), (3, 40), (4, 750))]
    device = [
        _x("kernel", "nvjet_tst_128x256_64x4_2x1_v_bz_TNT", 100, 100, 7, 1),
        _x("kernel", "void fwd_bf16_kernel<64>(CUtensorMap_st)", 200, 100,
           7, 2),
        _x("kernel", "void dkv_bf16_kernel<64>(CUtensorMap_st)", 250, 100,
           8, 3),
        _x("kernel", "void at::native::(anonymous namespace)::"
           "multi_tensor_apply_kernel<...>", 800, 50, 7, 4),
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 900, 10, 7),
        _x("gpu_user_annotation", "perfbench.step", 100, 810, 7),
        {"ph": "M", "name": "thread_name", "ts": 0, "tid": 1},
    ]
    return host + launches + device


def test_trace_reads_events():
    t = Trace(_events())
    assert len(t.kernels) == 4 and len(t.device) == 5
    assert t.busy_intervals() == [(100.0, 350.0), (800.0, 850.0),
                                  (900.0, 910.0)]
    assert t.busy_us() == 310.0
    assert [k.name[:6] for k in t.launched_in("perfbench.optimizer")] == \
        ["void a"]
    assert t.idle_gaps(0.0) == [
        ["perfbench.optimizer > aten::_foreach_add_", 450e-6],
        ["perfbench.step > aten::mm", 100e-6],
        ["unknown", 50e-6]]
    top = t.top_ops()
    assert top[0][1] == 100e-6 and len(top) == 5


def test_optimizer_kernels_without_a_range():
    # The burn-in step's SGD: the foreach kernels after the last dK/dV.
    t = Trace(_events(with_optimizer_range=False))
    assert [k.name for k in optimizer_kernels(t)] == [t.kernels[3].name]


def _run(events, launches, wall_s=1e-3, steps=1):
    cell = cells.load_cell("gpt2-xl.fit")
    return TracedRun(cell, Trace(events), steps, wall_s, launches, H100,
                     input_wait_s=2e-4, window_pulls=4)


def _read(name, run):
    return cells.metric_reader(name)(run)


def test_readers():
    run = _run(_events(), {"fwd": 1, "dq": 0, "dkv": 1})
    assert _read("device_idle_share", run) == pytest.approx(69.0)
    assert _read("optimizer_ms_per_step", run) == pytest.approx(0.05)
    assert _read("elementwise_ms_per_step", run) is None  # nothing else
    assert _read("input_wait_ms_per_step", run) == pytest.approx(0.05)
    # The forward call: its bound at [8, 1024, 25, 64] over 100 us.
    bound = flops.attention_bound_ms((8, 1024, 25, 64), "bfloat16", True,
                                     H100)[0]
    assert _read("attn_fwd_roofline", run) == pytest.approx(
        100 * bound / 0.1)
    # No dQ call in the trace: silent, never 0.
    assert _read("attn_bwd_roofline", run) is None
    work = flops.train_step_flops(run.cell.model, 8)
    assert _read("step_mfu", run) == pytest.approx(
        100 * work / 1e-3 / 989e12)


def test_readers_stay_silent_when_the_path_is_not_the_kernels():
    # The counters saw two forward launches; the trace holds one call.
    run = _run(_events(), {"fwd": 2, "dq": 0, "dkv": 1})
    assert _read("attn_fwd_roofline", run) is None
    run.peaks = None
    assert _read("step_mfu", run) is None
