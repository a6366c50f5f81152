"""All-reduce bandwidth probe: the port of ``kubeflow_tpu/probe/ici.py``.

Each rank of the current ``torch.distributed`` world (or of ``group``)
all-reduces its share of ``mbytes`` of bf16, the bytes each device holds
under the reference's ``P("x")``, and the slowest rank's mean time is
scored against the node shape's estimate
(``GpuSlice.allreduce_algo_bandwidth_gbps``). Over NCCL on the cards of a
node this exercises NVLink through the NVSwitches, across nodes the GPU
NICs; over gloo (tests, processes sharing one card) the same code runs
through the host, and only the *plumbing* means anything there.

Ring all-reduce moves ``2*(k-1)/k`` bytes per byte reduced: the reported
``algo_bandwidth_gbps = 2*(k-1)/k * bytes_per_device / mean / 1e9`` is
the reference's formula, the figure NCCL's tests call bus bandwidth. NCCL
may run NVLink SHARP (NVLS) on H100 nodes, which reduces inside the
switch and can beat the ring estimate: ``fraction_of_peak`` is not
clamped, so a value above 1 reads as such.
"""

from __future__ import annotations

import math
import tempfile
import time
from contextlib import contextmanager
from dataclasses import asdict, dataclass

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.gpu.topology import GpuSlice


@dataclass(frozen=True)
class IciReport:
    devices: int
    bytes_per_device: int
    iters: int
    mean_seconds: float
    algo_bandwidth_gbps: float     # per card
    peak_estimate_gbps: float | None
    fraction_of_peak: float | None
    backend: str

    def to_dict(self) -> dict:
        out = asdict(self)
        # A world of one moves no bytes between cards: bandwidth is
        # unbounded. JSON has no Infinity, so non-finite becomes None.
        for key, value in out.items():
            if isinstance(value, float) and not math.isfinite(value):
                out[key] = None
        return out


def algo_bandwidth_gbps(k: int, bytes_per_device: int,
                        mean_seconds: float) -> float:
    """The ring's bus bandwidth, GB/s a device; ``inf`` at one device."""
    if k <= 1:
        return float("inf")
    return (2 * (k - 1) / k) * bytes_per_device / mean_seconds / 1e9


@contextmanager
def _world_of_one(dev: torch.device):
    """A process group of this process alone (NCCL on the card, gloo on
    the CPU) when none is initialized; the current world otherwise."""
    if dist.is_initialized():
        yield
        return
    with tempfile.TemporaryDirectory(prefix="kftpu-probe-") as tmp:
        cuda = dev.type == "cuda"
        dist.init_process_group(
            "nccl" if cuda else "gloo",
            store=dist.FileStore(f"{tmp}/store", 1), world_size=1, rank=0,
            **({"device_id": dev} if cuda else {}))
        try:
            yield
        finally:
            dist.destroy_process_group()


def run_ici_probe(
    *,
    mbytes: float = 64.0,
    iters: int = 10,
    warmup: int = 3,
    group=None,
    accelerator: str | None = None,
    topology: str | None = None,
    device=None,
) -> IciReport:
    """All-reduce ``mbytes`` of bf16 across the world, ``iters`` times.

    Runs on the current card unless ``device`` says otherwise; with no
    card and no ``device`` it raises. Outside an initialized world it is
    a world of one (no bytes cross a card). Every rank of the group must
    call it, and every rank returns the same report."""
    dev = resolve_device(device)
    with _world_of_one(dev):
        k = dist.get_world_size(group)
        n_elems = int(mbytes * 1e6 / 2)  # bf16
        n_elems -= n_elems % k
        x = torch.ones(n_elems // k, dtype=torch.bfloat16, device=dev)
        dist.all_reduce(x, group=group)
        if not bool((x == k).all()):
            raise RuntimeError(f"all-reduce of ones over {k} ranks gave "
                               f"{x.unique().tolist()}")
        x.zero_()  # keep the timed sums finite
        for _ in range(warmup):
            dist.all_reduce(x, group=group)
        fence = torch.zeros(1, device=dev)
        dist.all_reduce(fence, group=group)  # every rank starts together
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            dist.all_reduce(x, group=group)
        _sync(dev)
        mean = torch.tensor([(time.perf_counter() - t0) / iters],
                            dtype=torch.float64, device=dev)
        dist.all_reduce(mean, op=dist.ReduceOp.MAX, group=group)
        mean = float(mean)
        backend = str(dist.get_backend(group))

    bytes_per_device = n_elems // k * 2
    algo_gbps = algo_bandwidth_gbps(k, bytes_per_device, mean)
    peak = fraction = None
    if accelerator and topology:
        peak = GpuSlice.parse(accelerator, topology) \
            .allreduce_algo_bandwidth_gbps()
        if peak and peak != float("inf"):
            fraction = algo_gbps / peak

    return IciReport(
        devices=k,
        bytes_per_device=bytes_per_device,
        iters=iters,
        mean_seconds=mean,
        algo_bandwidth_gbps=round(algo_gbps, 3),
        peak_estimate_gbps=(round(peak, 3)
                            if peak not in (None, float("inf")) else peak),
        fraction_of_peak=round(fraction, 4) if fraction is not None else None,
        backend=backend,
    )


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def world_rank(rank: int, mbytes: float, iters: int, accelerator,
               topology, device) -> dict:
    """One process of a spawned probe world (``parallel.launch``): its
    report as a dict."""
    return run_ici_probe(mbytes=mbytes, iters=iters, accelerator=accelerator,
                         topology=topology, device=device).to_dict()
