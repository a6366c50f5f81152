"""Notebook load test (the port of ``kubeflow_tpu/testing/loadtest.py``).

Reference: ``notebook-controller/loadtest/start_notebooks.py`` — spawn N
Notebook CRs from a template, wait, tear down. Ours runs against any
KubeApi (FakeKube for control-plane-only measurement, HttpKube for a real
cluster) and reports spawn latency percentiles — the number the reference
harness never recorded (SURVEY.md §6).
"""

from __future__ import annotations

import asyncio
import math
import time
from dataclasses import dataclass, field

from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.runtime.errors import ApiError
from kubeflow_tpu_torch.runtime.objects import deep_get


@dataclass
class LoadTestReport:
    notebooks: int
    ready: int
    wall_seconds: float
    p50_ready_seconds: float | None
    p95_ready_seconds: float | None
    failures: list[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return self.__dict__.copy()


async def run_load_test(
    kube,
    *,
    count: int = 50,
    namespace: str = "loadtest",
    namespaces: list[str] | None = None,
    accelerator: str | None = None,
    topology: str | None = None,
    timeout: float = 120.0,
    cleanup: bool = True,
    poll_interval: float = 0.05,
) -> LoadTestReport:
    """``namespaces`` spreads the CRs round-robin across several
    namespaces — required to load every shard of a namespace-hash
    sharded control plane (a single namespace hashes to ONE shard and
    would benchmark one replica no matter how many are running)."""
    nss = list(namespaces) if namespaces else [namespace]
    t0 = time.perf_counter()
    keyed = [(nss[i % len(nss)], f"load-{i}") for i in range(count)]
    for ns, name in keyed:
        await kube.create(
            "Notebook",
            nbapi.new(name, ns, accelerator=accelerator, topology=topology),
        )

    from kubeflow_tpu_torch.testing.fakekube import FakeKube

    # Read-only poll: the copy-free fast path exists only on FakeKube
    # (HttpKube keeps the standard signature).
    list_kwargs = {"copy": False} if isinstance(kube, FakeKube) else {}

    ready_at: dict[tuple, float] = {}
    failed: dict[tuple, str] = {}
    wanted = set(keyed)
    deadline = t0 + timeout
    while len(ready_at) + len(failed) < count and time.perf_counter() < deadline:
        # One list per namespace per poll pass (NOT a GET per notebook:
        # against a real apiserver the serialized round-trips would skew
        # the very spawn latencies being measured).
        listed: dict[tuple, dict] = {}
        for ns in nss:
            for nb in await kube.list("Notebook", ns, **list_kwargs):
                key = (ns, nb["metadata"]["name"])
                if key in wanted:
                    listed[key] = nb
        for key in keyed:
            if key in ready_at or key in failed:
                continue
            nb = listed.get(key)
            if nb is None:
                failed[key] = f"{key[0]}/{key[1]}: disappeared"
                continue
            want = deep_get(nb, "status", "gpu", "hosts", default=1) or 1
            if (deep_get(nb, "status", "readyReplicas", default=0) or 0) >= want:
                ready_at[key] = time.perf_counter() - t0
        await asyncio.sleep(poll_interval)

    wall = time.perf_counter() - t0
    for key in keyed:  # pending-at-deadline notebooks are failures too
        if key not in ready_at and key not in failed:
            failed[key] = f"{key[0]}/{key[1]}: not ready within {timeout}s"
    failures = list(failed.values())
    latencies = sorted(ready_at.values())

    def pct(p: float) -> float | None:
        """Nearest-rank percentile: ceil(p*n)-th smallest."""
        if not latencies:
            return None
        rank = max(1, math.ceil(p * len(latencies)))
        return latencies[rank - 1]

    if cleanup:
        for ns, name in keyed:
            try:
                await kube.delete("Notebook", name, ns)
            except ApiError:  # NotFound included — it subclasses ApiError
                pass  # cleanup is best-effort; the report already exists

    return LoadTestReport(
        notebooks=count,
        ready=len(ready_at),
        wall_seconds=round(wall, 3),
        p50_ready_seconds=round(pct(0.50), 4) if latencies else None,
        p95_ready_seconds=round(pct(0.95), 4) if latencies else None,
        failures=failures,
    )
