"""The span reader (``perfbench.spans``) and the metrics that read it: a
trace written by hand, with backward kernels launched on autograd's
thread inside the program's backward ranges and idle stretches split
across nested spans; a real CPU trace of the program's burn-in step; and
the seven older readers, which read what they read before, beside new
readers that stay silent on a trace with no span of the program."""

import importlib.util
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench import cells, flops, spans
from perfbench.harness import TracedRun
from perfbench.trace import STEP_RANGE, Trace

H100 = flops.peaks_for("NVIDIA H100 80GB HBM3")
NEW = ["embed_ms_per_step", "norm_ms_per_step", "attention_layer_ms_per_step",
       "mlp_layer_ms_per_step", "head_loss_ms_per_step", "clip_ms_per_step",
       "update_ms_per_step", "accumulate_ms_per_step",
       "update_idle_ms_per_step", "input_idle_ms_per_step",
       "unattributed_ms_per_step"]
# The older readers on test_perfbench_trace.py's trace, as the parent
# tree of this reader read them (with and without the optimizer range).
OLD = {"attn_fwd_roofline": 31.54531343283582, "attn_bwd_roofline": None,
       "step_mfu": 8118.848836076845, "elementwise_ms_per_step": None,
       "optimizer_ms_per_step": 0.05, "input_wait_ms_per_step": 0.05,
       "device_idle_share": 69.0}


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _span(name, ts, end, tid=1):
    return _x("user_annotation", "kftpu." + name, ts, end - ts, tid)


def _op(name, ts, end, tid=1):
    return _x("cpu_op", name, ts, end - ts, tid)


def _bwd(node, ts, end):
    return _op("autograd::engine::evaluate_function: " + node, ts, end, 2)


# (correlation, launch thread, launch time, device start, duration)
LAUNCHED = [(12, 1, 45, 60, 2), (1, 1, 101, 100, 10), (2, 1, 150, 110, 30),
            (3, 1, 216, 216, 20), (4, 1, 315, 320, 5), (5, 2, 335, 340, 40),
            (13, 2, 362, 380, 4), (6, 2, 375, 384, 6), (7, 2, 415, 420, 8),
            (8, 2, 452, 455, 2),
            (9, 1, 605, 620, 30), (10, 1, 615, 650, 20),
            (11, 1, 800, 805, 1)]


def _events():
    host = [
        _x("user_annotation", STEP_RANGE, 0, 1000),
        _span("data_wait", 0, 40), _span("data_stage", 40, 50),
        _span("train_step", 50, 990),
        _span("embed", 60, 80), _op("aten::embedding", 62, 64),
        _span("attention_layer", 90, 200), _span("norm", 95, 110),
        _op("aten::mul", 100, 102),
        _span("mlp_layer", 210, 300), _op("aten::mm", 215, 217),
        _span("loss", 310, 320),
        _span("update", 600, 700), _span("clip", 610, 640),
        # The backward ranges on autograd's thread follow one another;
        # each opens in the hook of its span's first node, inside that
        # node's evaluate op, so ranges and evaluate ops overlap.
        _bwd("MmBackward0", 330, 360), _span("mlp_layer", 331, 366, 2),
        # Its gradient sum, launched at 362 after the node's own work,
        # stays in the MLP's range.
        _bwd("MulBackward0", 365, 400), _span("norm", 366, 411, 2),
        _bwd("EmbeddingBackward0", 410, 440), _span("embed", 411, 445, 2),
        # A node made outside every span: no range.
        _bwd("torch::autograd::AccumulateGrad", 450, 460),
    ]
    launches = [_x("cuda_runtime", "cudaLaunchKernel", ts, 1, tid,
                   correlation=c) for c, tid, ts, _, _ in LAUNCHED]
    device = [_x("kernel", f"k{c}", start, dur, 7, correlation=c)
              for c, _, _, start, dur in LAUNCHED]
    # A device operation with no launch to tie it to.
    device.append(_x("gpu_memset", "Memset (Device)", 900, 1, 7))
    return host + launches + device


def _run(events, steps=1):
    return TracedRun(cells.load_cell("cerebras-gpt-1.3b.fit"),
                     Trace(events), steps, 1e-3, {"fwd": 0, "dq": 0,
                                                  "dkv": 0}, H100,
                     input_wait_s=2e-4, window_pulls=4)


def test_device_operations_go_to_their_spans():
    b = spans.book(Trace(_events()))
    assert b.device_us == {
        "data_stage": 2, "norm": 10 + 6, "attention_layer": 30,
        # The forward mm, its backward and the gradient sum after it.
        "mlp_layer": 20 + 40 + 4, "loss": 5, "embed": 8,
        "update": 30, "clip": 20, "train_step": 1,
        None: 2 + 1}          # no span at its launch; no launch


def test_idle_stretches_split_across_nested_spans():
    b = spans.book(Trace(_events()))
    assert b.idle_us == {
        "data_wait": 40, "data_stage": 10, "embed": 18, "norm": 5,
        "attention_layer": 5 + 60, "mlp_layer": 6 + 64, "loss": 10,
        "update": 10 + 30, "clip": 10,
        "train_step": 10 + 10 + 10 + 10 + 15 + 30 + 27 + 143 + 105 + 94}
    t = Trace(_events())
    assert sum(b.idle_us.values()) == 901 - t.busy_us()


def test_readers_per_step():
    run = _run(_events(), steps=2)
    got = {n: cells.metric_reader(n)(run) for n in NEW}
    assert got == pytest.approx({
        "embed_ms_per_step": 0.004, "norm_ms_per_step": 0.008,
        "attention_layer_ms_per_step": 0.015, "mlp_layer_ms_per_step": 0.032,
        "head_loss_ms_per_step": 0.0025, "clip_ms_per_step": 0.010,
        "update_ms_per_step": 0.015, "accumulate_ms_per_step": None,
        "update_idle_ms_per_step": 0.025, "input_idle_ms_per_step": 0.025,
        "unattributed_ms_per_step": 0.002})


def _older_trace_module():
    path = cells.PACKAGE / "tests" / "test_perfbench_trace.py"
    spec = importlib.util.spec_from_file_location("older_trace_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("with_range", [True, False])
def test_older_readers_read_what_they_read_before(with_range):
    events = _older_trace_module()._events(with_range)
    run = _run(events)
    run.cell = cells.load_cell("gpt2-xl.fit")
    run.launches = {"fwd": 1, "dq": 0, "dkv": 1}
    assert {n: cells.metric_reader(n)(run) for n in OLD} == OLD
    # The new readers find no span of the program there: silent.
    assert {n: cells.metric_reader(n)(run) for n in NEW} == \
        dict.fromkeys(NEW)


def test_a_real_cpu_trace_ties_every_backward_product_to_its_layer(tmp_path):
    """The burn-in step on the CPU under torch.profiler, each product op
    (forward, and backward inside autograd's evaluate ops) given a
    kernel of its own: every one lands in its layer's span."""
    from kubeflow_tpu_torch.models import burnin

    cfg = burnin.BurninConfig(vocab=64, d_model=32, n_heads=2, n_layers=2,
                              d_ff=64, seq_len=17, dtype="float32")
    params = burnin.init_params(cfg, seed=0, device="cpu")
    step = burnin.make_train_step(cfg)
    tokens = torch.randint(0, 64, (2, 17),
                           generator=torch.Generator().manual_seed(0))
    step(params, tokens)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(STEP_RANGE):
            step(params, tokens)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    products = [e for e in events if e.get("ph") == "X"
                and e.get("cat") == "cpu_op"
                and e["name"] in ("aten::mm", "aten::bmm")]
    for c, e in enumerate(products, 1):
        events.append(_x("cuda_runtime", "cudaLaunchKernel",
                         e["ts"] + 1e-3, 1e-3, e["tid"], correlation=c))
        events.append(_x("kernel", e["name"], 1e12 + 10 * c, 1.0, 7,
                         correlation=c))
    booked = spans.book(Trace(events)).device_us
    # Per layer: qkv and out products, q k^T and p v, forward (4) and
    # backward (8); the MLP's two (2 + 4); the tied head's one (1 + 2).
    assert booked == {"attention_layer": 12.0 * cfg.n_layers,
                      "mlp_layer": 6.0 * cfg.n_layers, "head": 3.0}
