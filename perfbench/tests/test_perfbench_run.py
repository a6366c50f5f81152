"""Whole runs on the CPU at a tiny size: the result line's shape, the
refusal without a card, the isolation of the reference and of the run,
and the faults and the control that the check has to catch.

The tiny cell's limits are its own (the full cells' come from readings on
the card): here sound runs read loss gaps of ~3e-5 and gradient and change
gaps of ~1e-3, the fp8 control ~1e-4 to 4e-4 and ~1.3e-2 on the
gradient, half a batch ~2e-3 and ~0.07 to 0.2."""

import ast
import json
import subprocess
import sys

import pytest
import torch

from kubeflow_tpu_torch.models import burnin, trainer

from perfbench import cells, control, harness, run

TINY_LIMITS = {"loss": 3e-4, "grad": 5e-3, "change": 5e-3}
FIT = {"optimizer": "adamw", "lr": 3e-4, "weight_decay": 0.01,
       "warmup_steps": 0, "decay_steps": 10_000, "grad_clip": 1.0}
SGD = {"optimizer": "sgd", "lr": 1e-3}


def tiny_cell(entry="fit", batch=4, accum=2, optimizer=FIT):
    config = {"model": {"vocab": 512, "d_model": 64, "n_heads": 2,
                        "n_layers": 2, "d_ff": 256, "attention": "flash",
                        "dtype": "bfloat16"}}
    workload = {"config": "tiny", "entry": entry, "batch": batch,
                "seq_len": 65, "accum_steps": accum, "optimizer": optimizer,
                "tokens": {"rows": 64, "zipf_exponent": 1.0,
                           "zipf_offset": 2.7},
                "limits": TINY_LIMITS}
    return cells.Cell("tiny", config, workload)


CELLS = {"fit": lambda: tiny_cell(),
         "burnin_step": lambda: tiny_cell("burnin_step", 2, 1, SGD)}


def _run(cell, seed=2 ** 31 + 3):
    return harness.run(cell, seed, 0.2, False, "cpu", 0.0)


@pytest.mark.parametrize("entry", sorted(CELLS))
def test_dry_run_line(entry):
    result = _run(CELLS[entry]())
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "kernels_built", "checks"]
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    # A CPU run reports no device metric.
    assert result["metrics"] == {}
    assert result["device"]["platform"] == "cpu"
    assert set(result["checks"]) == {"loss", "grad", "change"}
    json.dumps(result)


def test_main_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "gpt2-xl.fit", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def _half_loss(loss_fn):
    def half(params, tokens, *args, **kwargs):
        return loss_fn(params, tokens[: len(tokens) // 2], *args, **kwargs)
    return half


def _frozen_fit_step(loss_fn, optimizer, accum_steps=1, **_):
    def step(state, batch):
        loss = loss_fn(state["params"], batch).detach()
        return {**state, "step": state["step"] + 1}, loss
    return step


def _frozen_burnin_step(cfg, mesh=None, lr=1e-3):
    def step(params, tokens):
        return params, burnin.loss_fn(params, tokens, cfg).detach()
    return step


@pytest.mark.parametrize("entry", sorted(CELLS))
def test_half_batch_fails(entry, monkeypatch):
    monkeypatch.setattr(burnin, "loss_fn", _half_loss(burnin.loss_fn))
    result = _run(CELLS[entry]())
    assert result["correct"] is False


@pytest.mark.parametrize("entry", sorted(CELLS))
def test_unchanged_state_fails(entry, monkeypatch):
    monkeypatch.setattr(trainer, "make_train_step", _frozen_fit_step)
    monkeypatch.setattr(burnin, "make_train_step", _frozen_burnin_step)
    result = _run(CELLS[entry]())
    assert result["correct"] is False
    assert result["checks"]["change"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("entry", sorted(CELLS))
def test_control_fails_and_program_passes(entry):
    cell = CELLS[entry]()
    for seed in (5, 6, 7):
        prog, ref = control.readings(cell, seed, "program", "cpu")
        assert harness.passed(harness.checks(prog, ref, TINY_LIMITS))
        prog, ref = control.readings(cell, seed, "control", "cpu")
        assert not harness.passed(harness.checks(prog, ref, TINY_LIMITS))


@pytest.mark.parametrize("arm", ["half_batch", "frozen"])
@pytest.mark.parametrize("entry", sorted(CELLS))
def test_fault_arms_read_above_the_limits(entry, arm):
    prog, ref = control.readings(CELLS[entry](), 5, arm, "cpu")
    assert not harness.passed(harness.checks(prog, ref, TINY_LIMITS))


def test_forbidden_modules_compare_whole_names():
    assert harness.forbidden_modules(
        ["jax.numpy", "kubeflow_tpu_torch.data", "kubeflow_tpu.models",
         "jaxtyping", "flax"]) == ["flax", "jax", "kubeflow_tpu"]


def test_reference_imports_nothing_of_the_program():
    for path in (cells.PACKAGE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in (
                    "kubeflow_tpu_torch", "kubeflow_tpu", "jax", "jaxlib",
                    "flax", "perfbench"), (path.name, name)


def test_a_run_loads_no_forbidden_module():
    code = ("import perfbench.run, perfbench.harness, perfbench.control, "
            "perfbench.entries.fit, perfbench.entries.burnin_step\n"
            "from perfbench import cells, harness\n"
            "for m in cells.benchmark()['per_layer']:\n"
            "    cells.metric_reader(m['name'])\n"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=cells.ROOT, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU mode")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("entry", sorted(CELLS))
def test_control_reads_above_the_program_on_the_card(entry, card):
    # The kernels' path at a small size: heads of 64 over 1024 positions.
    cell = CELLS[entry]()
    cell.config["model"].update(vocab=4096, d_model=256, n_heads=4)
    cell.workload.update(seq_len=1025, batch=2,
                         accum_steps=min(2, cell.accum_steps))
    worst = {}
    for arm in ("program", "control"):
        prog, ref = control.readings(cell, 11, arm, card)
        worst[arm] = harness.gaps(prog, ref)
    assert worst["program"]["grad"] < 1e-2
    assert worst["control"]["grad"] > 3 * worst["program"]["grad"]
