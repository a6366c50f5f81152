"""The train step's registered spans (``telemetry.sections.span``): the
registry, the guard that enters no ``record_function`` while no profiler
collects, the names and nesting a CPU ``torch.profiler`` records, and
numbers that do not move with the profiler on."""

import json
import threading
from functools import partial

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from kubeflow_tpu_torch import data
from kubeflow_tpu_torch.models import burnin, trainer
from kubeflow_tpu_torch.models.tree import leaves
from kubeflow_tpu_torch.parallel import moe
from kubeflow_tpu_torch.telemetry import sections

torch.set_num_threads(1)

CFG = burnin.BurninConfig(vocab=64, d_model=32, n_heads=2, n_layers=2,
                          d_ff=64, seq_len=17, dtype="float32")
ADAMW = trainer.TrainerConfig(optimizer="adamw", lr=1e-3, warmup_steps=0,
                              decay_steps=10, grad_clip=1.0)
ACCUM = 2
MODEL_SPANS = {"embed", "norm", "attention_layer", "mlp_layer", "head",
               "loss"}


def _rows(n=8, seed=0):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab, (n, CFG.seq_len), dtype=np.int64)


def _batches(seed=0):
    """The program's input pipeline on the CPU: loader, prefetch thread,
    placement; each batch a ``[4, seq_len]`` tensor."""
    loader = data.ShardedLoader(data.ArraySource(_rows(seed=seed)), 4,
                                seed=seed, process_id=0, num_processes=1)
    prefetcher = data.prefetch(loader)
    placed = data.global_batches(prefetcher, device="cpu")
    return prefetcher, (batch for (batch,) in placed)


def _fit_job():
    params = burnin.init_params(CFG, seed=0, device="cpu")
    opt = trainer.make_optimizer(ADAMW)
    state = trainer.init_state(params, opt)
    step = trainer.make_train_step(partial(burnin.loss_fn, cfg=CFG), opt,
                                   accum_steps=ACCUM)
    prefetcher, batches = _batches()
    losses = []

    def run(steps):
        nonlocal state

        def recorded(st, batch):
            st, loss = step(st, batch)
            losses.append(loss)
            return st, loss

        state = trainer.fit(state, batches, steps=state["step"] + steps,
                            step_fn=recorded, skip_batches=False)
        return losses, leaves(state["params"])

    return run, prefetcher


def _burnin_job():
    params = burnin.init_params(CFG, seed=0, device="cpu")
    step = burnin.make_train_step(CFG, lr=1e-2)
    tokens = torch.from_numpy(_rows()[:4])
    losses = []

    def run(steps):
        nonlocal params
        for _ in range(steps):
            params, loss = step(params, tokens)
            losses.append(loss)
        return losses, leaves(params)

    return run, None


JOBS = {"fit": _fit_job, "burnin": _burnin_job}


def _moe_layer():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(16, 8, generator=g, requires_grad=True)
    router = torch.randn(8, 4, generator=g)
    w1 = torch.randn(4, 8, 16, generator=g)
    w2 = torch.randn(4, 16, 8, generator=g)
    y, aux = moe.moe_ffn_local(x, router, w1, w2, None)
    torch.autograd.grad(y.sum() + aux, x)


BACKWARD_OP = "autograd::engine::evaluate_function: "


def _events_of(prof, tmp_path) -> list:
    """A finished profile's complete events, from its Chrome trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"]


def _ranges(events: list, backward: bool) -> list:
    """The ``kftpu.*`` ranges as ``(name, ts, end, tid)``: those that open
    inside an autograd evaluate op (the backward's) or the others."""
    evaluate = [e for e in events if e["name"].startswith(BACKWARD_OP)]

    def in_backward(e):
        return any(b["tid"] == e["tid"]
                   and b["ts"] <= e["ts"] <= b["ts"] + b["dur"]
                   for b in evaluate)

    return [(e["name"][len("kftpu."):], e["ts"], e["ts"] + e["dur"],
             e["tid"]) for e in events
            if e["name"].startswith("kftpu.") and in_backward(e) == backward]


def _spans_of(prof, tmp_path) -> list:
    """The forward's ``kftpu.*`` ranges of a finished profile as ``(name,
    ts, end, tid)``."""
    return _ranges(_events_of(prof, tmp_path), backward=False)


def _parents(spans: list) -> dict:
    """``{name: set of names of the innermost enclosing span}`` (None at
    the top)."""
    out = {}
    for name, ts, end, tid in spans:
        around = [s for s in spans if s[3] == tid and s[1] <= ts
                  and end <= s[2] and s[:3] != (name, ts, end)]
        inner = max(around, key=lambda s: s[1], default=None)
        out.setdefault(name, set()).add(inner[0] if inner else None)
    return out


def test_span_registry():
    names = [spec[0] for spec in sections.SPAN_SPECS]
    assert len(names) == len(set(names)) == len(sections.SPAN_NAMES)
    assert not sections.SPAN_NAMES & sections.SECTION_NAMES
    for name, module, desc in sections.SPAN_SPECS:
        assert module.startswith("kubeflow_tpu_torch/") and desc
    with pytest.raises(ValueError, match="unregistered telemetry span"):
        sections.span("no_such_span")
    with pytest.raises(ValueError, match="unregistered telemetry span"):
        sections.span("ring_kv_hop")        # a collective's, not a span's


def test_spans_are_one_shared_null_context_without_a_profiler():
    assert sections.span("norm") is sections.span("train_step", 3)
    with sections.span("norm") as entered:
        assert entered is None


def _count_record_function(monkeypatch) -> list:
    """Every name the program hands ``torch.profiler.record_function``."""
    names = []
    real = torch.profiler.record_function

    def counting(name, args=None):
        names.append(name)
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return names


@pytest.mark.parametrize("job", sorted(JOBS))
def test_no_record_function_without_a_profiler(job, monkeypatch):
    names = _count_record_function(monkeypatch)
    hooks = []
    real_hook = sections._backward_hook
    monkeypatch.setattr(sections, "_backward_hook",
                        lambda name: hooks.append(name) or real_hook(name))
    run, prefetcher = JOBS[job]()
    run(2)
    _moe_layer()
    assert sections.collective("ring_kv_hop", torch.add, torch.ones(2),
                               1).tolist() == [2.0, 2.0]
    if prefetcher is not None:
        prefetcher.close()
    assert names == [] and hooks == []
    # The same calls under a profiler do enter it: the count is live.
    with profile(activities=[ProfilerActivity.CPU]):
        _moe_layer()
        sections.collective("ring_kv_hop", torch.add, torch.ones(2), 1)
    assert set(names) == {"kftpu.moe_router", "kftpu.moe_seat_table",
                          "kftpu.moe_dispatch", "kftpu.moe_expert_ffn",
                          "kftpu.moe_combine", "kftpu.ring_kv_hop"}


def test_fit_step_records_every_span_nested(tmp_path):
    run, prefetcher = _fit_job()
    run(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(1)
    prefetcher.close()
    spans = _spans_of(prof, tmp_path)
    parents = _parents(spans)
    count = {n: sum(1 for s in spans if s[0] == n) for n in parents}
    assert parents == {
        "data_wait": {None}, "data_stage": {None},
        "train_step": {None},
        "embed": {"train_step"}, "attention_layer": {"train_step"},
        "mlp_layer": {"train_step"}, "head": {"train_step"},
        "loss": {"train_step"}, "accumulate": {"train_step"},
        "norm": {"attention_layer", "mlp_layer", "train_step"},
        "update": {"train_step"}, "clip": {"update"}}
    assert count["train_step"] == count["update"] == count["clip"] == 1
    assert count["accumulate"] == count["embed"] == count["loss"] == ACCUM
    assert count["attention_layer"] == CFG.n_layers * ACCUM
    assert count["norm"] == (2 * CFG.n_layers + 1) * ACCUM


def test_burnin_step_records_every_span_nested(tmp_path):
    run, _ = _burnin_job()
    run(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(1)
    parents = _parents(_spans_of(prof, tmp_path))
    assert parents == {
        "train_step": {None}, "embed": {"train_step"},
        "attention_layer": {"train_step"}, "mlp_layer": {"train_step"},
        "head": {"train_step"}, "loss": {"train_step"},
        "norm": {"attention_layer", "mlp_layer", "train_step"},
        "update": {"train_step"}}


def _backward_order(n_layers: int) -> list:
    """A step's backward ranges, in order: the forward's innermost spans
    backwards."""
    layers = ["norm", "mlp_layer", "norm", "attention_layer"] * n_layers
    return ["loss", "head"] + layers + ["norm", "embed"]


@pytest.mark.parametrize("job", sorted(JOBS))
def test_backward_runs_in_the_forward_spans(job, tmp_path):
    run, prefetcher = JOBS[job]()
    run(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(1)
    if prefetcher is not None:
        prefetcher.close()
    events = _events_of(prof, tmp_path)
    backward = sorted(_ranges(events, backward=True), key=lambda r: r[1])
    micro = ACCUM if job == "fit" else 1
    assert [r[0] for r in backward] == _backward_order(CFG.n_layers) * micro
    # One after another, each inside the step's range.
    (step,) = [r for r in _ranges(events, backward=False)
               if r[0] == "train_step"]
    for a, b in zip(backward, backward[1:]):
        assert a[2] <= b[1]
    assert all(step[1] <= r[1] and r[2] <= step[2] and r[3] == step[3]
               for r in backward)


@pytest.mark.parametrize("job", sorted(JOBS))
def test_each_backward_node_runs_in_the_span_that_made_it(job, tmp_path):
    """Autograd's sequence numbers tie each node's backward op to the
    forward op that made the node (the latest-starting forward op with
    the number: an op may read the number without making a node); the
    backward op runs inside the backward range of that op's forward
    span."""
    run, prefetcher = JOBS[job]()
    run(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(1)
    if prefetcher is not None:
        prefetcher.close()
    events = _events_of(prof, tmp_path)
    forward = _ranges(events, backward=False)
    backward = _ranges(events, backward=True)
    makers, nodes = {}, []
    for e in events:
        args = e.get("args") or {}
        seq = args.get("Sequence number")
        if e.get("cat") != "cpu_op" or seq is None:
            continue
        if args.get("Fwd thread id"):
            nodes.append(e)
        elif seq not in makers or e["ts"] >= makers[seq]["ts"]:
            makers[seq] = e

    def innermost(ranges, e, at):
        around = [r for r in ranges
                  if r[3] == e["tid"] and r[1] <= at <= r[2]]
        return max(around, key=lambda r: (r[1], -r[2]),
                   default=(None,))[0]

    for e in nodes:
        maker = makers[e["args"]["Sequence number"]]
        made_in = innermost(forward, maker, maker["ts"])
        runs_in = (innermost(backward, e, e["ts"] + e["dur"] / 2)
                   or "train_step")
        assert runs_in == made_in, (e["name"], maker["name"])
    checked = len(nodes)
    assert checked > 20 * CFG.n_layers


def test_moe_stages_keep_their_trace_names(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _moe_layer()
    assert [s[0] for s in sorted(_spans_of(prof, tmp_path),
                                 key=lambda s: s[1])] == [
        "moe_router", "moe_seat_table", "moe_dispatch", "moe_expert_ffn",
        "moe_combine"]


def test_spans_record_in_an_every_thread_session(tmp_path):
    # The profiler server's CPU sessions record every thread's ops, and
    # torch's per-thread check reads false there: spans still record.
    done = threading.Event()
    go = threading.Event()

    def worker():
        go.wait(timeout=30)
        with sections.span("data_wait"):
            torch.ones(2).sum()
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    config = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=config) as prof:
        go.set()
        assert done.wait(timeout=30)
    t.join(timeout=30)
    assert not t.is_alive()
    assert [s[0] for s in _spans_of(prof, tmp_path)] == ["data_wait"]


@pytest.mark.parametrize("job", sorted(JOBS))
def test_numbers_are_bitwise_the_same_under_a_profiler(job):
    plain_run, plain_pf = JOBS[job]()
    plain_losses, plain_leaves = plain_run(2)
    traced_run, traced_pf = JOBS[job]()
    with profile(activities=[ProfilerActivity.CPU]):
        traced_losses, traced_leaves = traced_run(2)
    for pf in (plain_pf, traced_pf):
        if pf is not None:
            pf.close()
    assert [float(v) for v in plain_losses] == \
        [float(v) for v in traced_losses]
    assert len(plain_leaves) == len(traced_leaves)
    for a, b in zip(plain_leaves, traced_leaves):
        assert torch.equal(a, b)
