"""Cells, configurations and per-layer metrics, found by name.

``BENCHMARK.json`` names each cell's configuration and traffic; the cell's
own file, ``perfbench/workloads/<cell>.json``, holds its job (entry,
batch, sequence, accumulation, optimizer, tokens) and the limits of its
correctness check; the configuration's file holds the model's sizes as
run (``model``). A per-layer metric is
``perfbench/metrics/<name>.py``, whose ``read(run)`` returns the number
or None. Adding any of these is adding files and entries: no file here
changes. A cell's ``mesh`` (its file's key) runs its job over one rank a
card (``perfbench.launch``).
"""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass, field
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


@dataclass
class Cell:
    name: str
    config: dict
    workload: dict
    chips: int = 1
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def model(self) -> dict:
        """The burn-in config's fields, with the cell's sequence."""
        return {**self.config["model"], "seq_len": self.workload["seq_len"]}

    @property
    def entry(self) -> str:
        return self.workload["entry"]

    @property
    def batch(self) -> int:
        return self.workload["batch"]

    @property
    def accum_steps(self) -> int:
        return self.workload.get("accum_steps", 1)

    @property
    def optimizer(self) -> dict:
        return self.workload["optimizer"]

    @property
    def checked_steps(self) -> int:
        """The first steps that the reference follows."""
        return self.workload.get("checked_steps", 3)

    @property
    def limits(self) -> dict:
        return self.workload["limits"]

    @property
    def mesh(self) -> dict | None:
        """The job's mesh plan (``{"data": ..., "model": ...}``, one rank a
        card), or None for a job on one card."""
        return self.workload.get("mesh")

    @property
    def attention_shape(self) -> tuple:
        """One attention call's ``[b, s, h, d]`` on one card: a
        microbatch's rows over that card's share of the heads (the heads
        over the mesh's model axis)."""
        m = self.model
        shards = (self.mesh or {}).get("model", 1)
        return (self.batch // self.accum_steps, m["seq_len"] - 1,
                m["n_heads"] // shards, m["d_model"] // m["n_heads"])

    @property
    def trained_positions(self) -> int:
        """Positions one step trains: batch x (seq_len - 1)."""
        return self.batch * (self.workload["seq_len"] - 1)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with its files."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    workload = _json(PACKAGE / "workloads" / f"{name}.json")
    if workload["config"] != entry["config"]:
        raise ValueError(f"{name}: its file names config "
                         f"{workload['config']!r}, BENCHMARK.json "
                         f"{entry['config']!r}")

    def applies(metric):
        return name in metric.get("workloads", [name])

    return Cell(name, _json(root / config["file"]), workload, entry["chips"],
                [m for m in bench["end_to_end"] if applies(m)],
                [m for m in bench["per_layer"] if applies(m)])


def entry_module(name: str):
    return importlib.import_module(f"perfbench.entries.{name}")


def metric_reader(name: str):
    return importlib.import_module(f"perfbench.metrics.{name}").read
