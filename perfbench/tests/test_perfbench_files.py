"""BENCHMARK.json, the configuration and cell files, the entries and the
metric readers: each found by name, each consistent with the others."""

import importlib
import json
import re

import pytest

from perfbench import cells, inputs

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
WIDTHS = ("d_model", "n_heads", "d_ff", "vocab")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_config_file(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    body = json.loads((cells.ROOT / config["file"]).read_text())
    assert body["name"] == config["name"]
    assert body["reduced"] == config["reduced"]
    model = body["model"]
    published = body["published"]
    assert model["d_model"] == published["n_embd"]
    assert model["n_heads"] == published["n_head"]
    assert model["n_layers"] == published["n_layer"]
    assert model["vocab"] == published["vocab_size"]
    assert model["d_ff"] == (published["n_inner"] or 4 * published["n_embd"])
    assert not any(w in config["reduced"] for w in WIDTHS)
    assert body["departures"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_file(cell):
    assert NAME.match(cell["name"]) and len(cell["why"]) <= 200
    c = cells.load_cell(cell["name"])
    # One card, or one rank a card over the cell's whole mesh.
    ranks = c.mesh["data"] * c.mesh["model"] if c.mesh else 1
    assert cell["chips"] == ranks and ranks in (1, 4)
    assert c.config["name"] == cell["config"]
    assert c.entry in ("fit", "burnin_step")
    cells.entry_module(c.entry)
    assert set(c.limits) == {"loss", "grad", "change"}
    assert c.batch % c.accum_steps == 0
    # The loader's first checked batches are whole and distinct rows.
    assert c.workload["tokens"]["rows"] >= c.checked_steps * c.batch
    assert [m["name"] for m in c.end_to_end] == [
        "train_tokens_per_s", "peak_mem_gib", "setup_s"]
    named = [m["name"] for m in BENCH["per_layer"]
             if cell["name"] in m["workloads"]]
    assert [m["name"] for m in c.per_layer] == named and named


def test_pairs_and_names_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(set(names)) == len(names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert all(NAME.match(n) for n in metrics)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cell_names = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cell_names
        assert callable(cells.metric_reader(m["name"]))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_metric_file_is_named_in_benchmark():
    named = {m["name"] for m in BENCH["per_layer"]}
    files = {p.stem for p in (cells.PACKAGE / "metrics").glob("*.py")
             if p.stem != "__init__"}
    assert files == named


def test_leaf_names_follow_the_program_tree():
    from kubeflow_tpu_torch.models import burnin
    from kubeflow_tpu_torch.models.tree import leaves

    model = {"vocab": 32, "d_model": 16, "n_heads": 2, "n_layers": 2,
             "d_ff": 24, "seq_len": 9, "attention": "flash",
             "dtype": "bfloat16"}
    weights = inputs.make_weights(model, 5, "cpu")
    tree = inputs.as_tree(weights, model)
    shapes = leaves(burnin.param_shapes(burnin.BurninConfig(**model)))
    assert [tuple(t.shape) for t in leaves(tree)] == [tuple(s)
                                                      for s in shapes]
    assert [weights[n] is t for n, t in zip(inputs.leaf_names(model),
                                            leaves(tree))] == \
        [True] * len(shapes)


def test_inputs_repeat_by_seed():
    model = {"vocab": 32, "d_model": 16, "n_heads": 2, "n_layers": 1,
             "d_ff": 24, "seq_len": 9}
    a = inputs.make_weights(model, 2 ** 31 + 17, "cpu")
    b = inputs.make_weights(model, 2 ** 31 + 17, "cpu")
    c = inputs.make_weights(model, 3, "cpu")
    assert all((a[n] == b[n]).all() for n in a)
    assert not (a["embed"] == c["embed"]).all()
    again = inputs.make_group(model, 2 ** 31 + 17, 1, "cpu")
    assert all((again[n] == a[n]).all() for n in again)
    tokens = {"rows": 6, "zipf_exponent": 1.0, "zipf_offset": 2.7}
    r1 = inputs.token_rows(tokens, 32, 9, 11)
    assert r1.shape == (6, 9) and r1.min() >= 0 and r1.max() < 32
    assert (r1 == inputs.token_rows(tokens, 32, 9, 11)).all()
    assert len({tuple(r) for r in r1}) == 6


@pytest.mark.parametrize("module", ["perfbench.entries.fit",
                                    "perfbench.entries.burnin_step"])
def test_entries_build(module):
    assert callable(importlib.import_module(module).build)
