"""A cell over several cards, on the CPU at a tiny size: the launcher (one
process a rank over gloo), a whole run of the harness over four ranks,
the sharded readings against the unsharded ones, the reference placed
over several devices, the readers' per-card arithmetic, and the runs a
raising or hung rank must end. Every multi-process test is held to a
deadline of its own."""

import json
import time

import pytest
import torch

from perfbench import cells, control, harness, launch, run
from perfbench.metrics import (collective_exposed_ms_per_step,
                               collective_ms_per_step,
                               elementwise_ms_per_step, step_mfu)
from perfbench.trace import Event, is_collective

LIMITS = {"loss": 3e-4, "grad": 5e-3, "change": 5e-3}
ADAMW = {"optimizer": "adamw", "lr": 3e-4, "weight_decay": 0.01,
         "warmup_steps": 0, "decay_steps": 10_000, "grad_clip": 1.0}
SGD = {"optimizer": "sgd", "lr": 1e-2, "grad_clip": 1.0}
# Seconds a multi-process test may take: four processes import torch.
DEADLINE_S = 120.0


def tiny_cell(mesh=True, dtype="bfloat16", attention="flash",
              optimizer=ADAMW):
    """Four heads and a d_ff of 256: a model axis of 4 cuts every layer's
    qkv, attn_out, ff1 and ff2."""
    config = {"model": {"vocab": 512, "d_model": 64, "n_heads": 4,
                        "n_layers": 2, "d_ff": 256, "attention": attention,
                        "dtype": dtype}}
    workload = {"config": "tiny", "entry": "fit", "batch": 4,
                "seq_len": 65, "accum_steps": 2, "optimizer": optimizer,
                "tokens": {"rows": 64, "zipf_exponent": 1.0,
                           "zipf_offset": 2.7},
                "limits": LIMITS}
    if mesh:
        workload["mesh"] = {"data": 1, "model": 4}
    return cells.Cell("tiny", config, workload, 4 if mesh else 1)


def _spawn(fn, args, deadline_s=DEADLINE_S):
    t0 = time.perf_counter()
    code = launch.spawn(fn, 4, args, t0, deadline_s, "cpu")
    return code, time.perf_counter() - t0


def test_a_run_over_four_ranks(capfd):
    started = time.perf_counter()
    code, _ = _spawn(run.rank_run, (tiny_cell(), 2 ** 31 + 3, 0.3, False,
                                    started))
    out, err = capfd.readouterr()
    assert code == 0, err
    lines = out.strip().splitlines()
    assert len(lines) == 1                # rank 0 alone prints
    result = json.loads(lines[-1])
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] >= 3
    # A CPU run reports no device metric.
    assert result["metrics"] == {}
    assert result["device"] == {"platform": "cpu", "count": 4}
    assert err.strip().splitlines()[-1].startswith("check change:")


def _faulty_rank(ranks, fault, cell, seed, started):
    """A rank of a run with the timed path broken underneath."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.models import burnin, trainer

    if fault == "half_batch":
        whole = burnin.loss_fn

        def half(params, tokens, *args, **kwargs):
            return whole(params, tokens[: len(tokens) // 2], *args, **kwargs)
        burnin.loss_fn = half
    elif fault == "frozen":
        def frozen(loss_fn, optimizer, accum_steps=1, mesh=None, rules=None):
            def step(state, batch):
                loss = loss_fn(state["params"], batch).detach()
                dist.all_reduce(loss)
                return {**state, "step": state["step"] + 1}, loss
            return step
        trainer.make_train_step = frozen
    elif fault == "no_exchange":
        trainer.reduce_grads = control._no_exchange
    return run.rank_run(ranks, cell, seed, 0.3, False, started)


@pytest.mark.parametrize("fault", ["half_batch", "frozen", "no_exchange"])
def test_a_broken_run_over_four_ranks_is_not_correct(fault, capfd):
    code, _ = _spawn(_faulty_rank, (fault, tiny_cell(), 2 ** 31 + 5,
                                    time.perf_counter()))
    out, err = capfd.readouterr()
    assert code == 0, err
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is False
    if fault == "frozen":
        assert result["checks"]["change"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("arm", ["half_batch", "frozen", "no_exchange"])
def test_fault_arms_over_four_ranks_read_above_the_limits(arm, tmp_path):
    path = tmp_path / "fault.json"
    code, _ = _spawn(_readings_rank, (tiny_cell(), 5, str(path), arm))
    assert code == 0
    prog, ref = json.loads(path.read_text())
    assert not harness.passed(harness.checks(prog, ref, LIMITS))


def _readings_rank(ranks, cell, seed, path, arm="program"):
    pair = control.readings(cell, seed, arm, ranks.device, ranks)
    if pair is not None:
        with open(path, "w") as f:
            json.dump(pair if arm != "program" else pair[0], f)
    return 0


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_sharded_readings_equal_the_unsharded(optimizer, tmp_path):
    # f32 compute and plain attention: the sharded and unsharded programs
    # part by summation order alone.
    opt = SGD if optimizer == "sgd" else ADAMW
    kw = {"dtype": "float32", "attention": "xla", "optimizer": opt}
    path = tmp_path / "sharded.json"
    code, _ = _spawn(_readings_rank, (tiny_cell(**kw), 11, str(path)))
    assert code == 0
    sharded = json.loads(path.read_text())
    whole, _ = control.readings(tiny_cell(mesh=False, **kw), 11, "program",
                                "cpu")
    assert sharded["losses"] == pytest.approx(whole["losses"], rel=1e-5)
    for key in ("grad_norms", "change_norms"):
        assert set(sharded[key]) == set(whole[key])
        for name, value in whole[key].items():
            assert sharded[key][name] == pytest.approx(value, rel=1e-4), \
                (key, name)


class _SumOf:
    """A stand-in for ``launch.Ranks`` over blocks held in one process:
    its sum adds each rank's values."""

    def __init__(self, per_rank):
        self.per_rank = per_rank

    def sum(self, values):
        return [sum(col) for col in zip(*self.per_rank)]


def test_global_norms_of_blocks_are_the_leaves_norms():
    gen = torch.Generator().manual_seed(3)
    leaves = {"qkv": torch.randn(16, 48, generator=gen),
              "ff2": torch.randn(24, 16, generator=gen),
              "ln1": torch.randn(16, generator=gen)}
    cut = {"qkv": True, "ff2": True, "ln1": False}
    # Four ranks' blocks: the cut leaves in four, the whole one on each.
    blocks = [{n: (t.chunk(4, dim=-1 if n == "qkv" else 0)[r] if cut[n]
                   else t) for n, t in leaves.items()} for r in range(4)]
    norms = [{n: float(torch.linalg.vector_norm(b.double()))
              for n, b in rank.items()} for rank in blocks]
    per_rank = [[v ** 2 if cut[n] else 0.0 for n, v in rank.items()]
                for rank in norms]
    got = harness.global_norms(norms[0], cut, _SumOf(per_rank))
    for n, t in leaves.items():
        assert got[n] == pytest.approx(
            float(torch.linalg.vector_norm(t.double())), rel=1e-12)


def test_reference_over_devices_is_the_one_device_reference():
    cell = tiny_cell(mesh=False, dtype="float32")
    rows, feed, job = harness.build(cell, 5, torch.device("cpu"))
    feed.close()
    one = harness.reference_readings(cell, rows, 5, "cpu")
    placed = harness.reference_readings(cell, rows, 5, "cpu",
                                        devices=["cpu"] * 3)
    assert placed == one


def test_placement_puts_layers_in_runs_and_the_head_first():
    assert harness.placement(32, list("abcd")) == (
        ["a"] + ["a"] * 8 + ["b"] * 8 + ["c"] * 8 + ["d"] * 8)
    assert harness.placement(3, ["x"]) == ["x"] * 4
    assert harness.placement(2, list("abcd")) == ["a", "a", "c"]


def test_attention_shape_is_one_cards():
    assert tiny_cell(mesh=False).attention_shape == (2, 64, 4, 16)
    assert tiny_cell().attention_shape == (2, 64, 1, 16)
    for w in cells.benchmark()["workloads"]:
        c = cells.load_cell(w["name"])
        m = c.model
        heads = m["n_heads"] // (c.mesh or {"model": 1})["model"]
        assert c.attention_shape[2] == heads


class _View:
    def __init__(self, cell, kernels, steps=1, wall_s=1.0):
        from perfbench import flops

        self.cell, self.steps, self.wall_s = cell, steps, wall_s
        self.peaks = flops.PEAKS[-1][1]
        self.trace = type("T", (), {"kernels": kernels})()


def test_step_mfu_divides_by_the_cells_cards():
    one, four = tiny_cell(mesh=False), tiny_cell()
    assert step_mfu.read(_View(four, [])) == pytest.approx(
        step_mfu.read(_View(one, [])) / 4, rel=1e-15)
    from perfbench import flops

    expected = (100.0 * flops.train_step_flops(one.model, one.batch)
                / flops.PEAKS[-1][1].bf16_flops)
    assert step_mfu.read(_View(one, [])) == expected


def test_elementwise_leaves_out_collectives(monkeypatch):
    monkeypatch.setattr(elementwise_ms_per_step, "optimizer_kernels",
                        lambda trace: [])
    kernels = [Event("vectorized_elementwise_kernel", 0.0, 1000.0),
               Event("ncclDevKernel_AllReduce_Sum_bf16_RING_LL(x)", 1000.0,
                     500.0),
               Event("nvjet_tst_192x192", 1500.0, 300.0)]
    view = _View(tiny_cell(), kernels)
    assert elementwise_ms_per_step.read(view) == 1.0
    assert is_collective(kernels[1].name) and not is_collective("gemm")
    assert elementwise_ms_per_step.read(_View(tiny_cell(), kernels[:1])) \
        == 1.0


def test_collectives_and_their_exposed_time():
    kernels = [Event("gemm", 0.0, 100.0),
               Event("ncclDevKernel_AllReduce", 50.0, 100.0),
               Event("ncclDevKernel_AllReduce", 200.0, 60.0),
               Event("elementwise_kernel", 220.0, 10.0)]
    view = _View(tiny_cell(), kernels, steps=2)
    assert collective_ms_per_step.read(view) == pytest.approx(0.08)
    # 150 - 100 uncovered of the first, 60 - 10 of the second.
    assert collective_exposed_ms_per_step.read(view) == pytest.approx(0.05)
    quiet = _View(tiny_cell(), [kernels[0], kernels[3]])
    assert collective_ms_per_step.read(quiet) is None
    assert collective_exposed_ms_per_step.read(quiet) is None


class _Store:
    def __init__(self):
        self.keys = {}

    def set(self, key, value):
        self.keys[key] = value

    def check(self, keys):
        return all(k in self.keys for k in keys)

    def get(self, key):
        return self.keys[key].encode()


def test_ranks_agree_on_a_step_rank_0_fixes():
    store = _Store()
    lead = launch.Ranks(0, 4, None, store, None)
    other = launch.Ranks(1, 4, None, store, None)
    assert not other.step_due("stop", 5, True)      # only rank 0 decides
    assert not lead.step_due("stop", 6, False)
    assert not lead.step_due("stop", 7, True)       # fixed at 7 + MARGIN
    assert not other.step_due("stop", 8, False)
    assert other.step_due("stop", 7 + launch.MARGIN, False)
    assert lead.step_due("stop", 7 + launch.MARGIN + 4, False)
    late = launch.Ranks(2, 4, None, store, None)
    with pytest.raises(RuntimeError):
        late.step_due("stop", 7 + launch.MARGIN + 1, False)


def _raising_rank(ranks):
    import torch.distributed as dist

    if ranks.rank == 2:
        raise ValueError("a fault in rank 2")
    dist.barrier()                                  # never completes
    return 0


def _hung_rank(ranks):
    if ranks.rank == 1:
        time.sleep(3600)
    return 0


def test_a_raising_rank_ends_the_run(capfd):
    code, took = _spawn(_raising_rank, ())
    assert code != 0 and took < DEADLINE_S
    assert "a fault in rank 2" in capfd.readouterr().err


def test_a_hung_rank_ends_at_the_deadline(capfd):
    code, took = _spawn(_hung_rank, (), deadline_s=20.0)
    assert code == 124 and 20.0 <= took < 40.0
    assert "still running" in capfd.readouterr().err
