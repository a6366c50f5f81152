"""The Python side of the native DCN ring probe (``native/dcn_probe.cpp``):
a copy of ``kubeflow_tpu/probe/dcn.py``.

Locates (or builds) the ``dcn_probe`` binary and runs one rank per node.
In a pod the rank and peers come from the node env the controller
injected (``gpu/topology.py``: ``TPU_WORKER_ID``,
``TPU_WORKER_HOSTNAMES``, ``KFTPU_SLICE_PEERS``); in tests all ranks run
as local subprocesses over loopback. What differs from the reference: the
binary is built into the port's library directory
(``ops/_build.BUILD_DIR``, gitignored), never into ``native/``, under a
name keyed by the source's hash, through a temporary file and an atomic
rename; and of a node's per-card processes (``LOCAL_RANK``) only the
first takes part in a ring.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import socket
import subprocess
from dataclasses import asdict, dataclass
from pathlib import Path

from kubeflow_tpu_torch.gpu.topology import SLICE_PEERS_ENV
from kubeflow_tpu_torch.ops import _build

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SOURCE = NATIVE_DIR / "dcn_probe.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-pthread")


@dataclass(frozen=True)
class DcnReport:
    """Scored cross-slice (or cross-node) ring result, the DCN analogue of
    ``probe.ici.IciReport``. ``min_gbps`` is the slowest rank: a ring is
    only as fast as its weakest link, so that is the number scored."""

    world: int
    mbytes: float
    iters: int
    min_gbps: float
    mean_gbps: float
    peak_estimate_gbps: float | None
    fraction_of_peak: float | None

    def to_dict(self) -> dict:
        out = asdict(self)
        for key, value in out.items():
            if isinstance(value, float) and not math.isfinite(value):
                out[key] = None  # JSON has no Infinity
        return out


def score_reports(reports: list[dict], multi=None) -> DcnReport:
    """Fold per-rank probe JSON into one scored report.

    ``multi``: a ``gpu.topology.MultiSlice``; when given (and
    multi-slice), the measured ring rate is scored against its
    ``dcn_ring_bandwidth_gbps()`` estimate, as the all-reduce probe scores
    against ``allreduce_algo_bandwidth_gbps``."""
    if not reports:
        raise DcnProbeError("no rank reports to score")
    rates = [r["gbps"] for r in reports if r.get("gbps") is not None]
    if not rates:  # world=1 sentinel report: no inter-node traffic
        min_gbps = mean_gbps = float("inf")
    else:
        min_gbps = min(rates)
        mean_gbps = sum(rates) / len(rates)
    peak = fraction = None
    if multi is not None:
        peak = multi.dcn_ring_bandwidth_gbps()
        if peak and math.isfinite(peak) and math.isfinite(min_gbps):
            fraction = min_gbps / peak
    return DcnReport(
        world=max(int(r.get("world", 1)) for r in reports),
        mbytes=float(reports[0].get("mbytes", 0.0)),
        iters=int(reports[0].get("iters", 0)),
        min_gbps=round(min_gbps, 3) if math.isfinite(min_gbps) else min_gbps,
        mean_gbps=round(mean_gbps, 3) if math.isfinite(mean_gbps) else mean_gbps,
        peak_estimate_gbps=(round(peak, 3)
                            if peak is not None and math.isfinite(peak)
                            else peak),
        fraction_of_peak=(round(fraction, 4)
                          if fraction is not None else None),
    )


class DcnProbeError(RuntimeError):
    pass


def binary_path() -> Path:
    """Where the binary built from :data:`SOURCE` lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return _build.BUILD_DIR / f"dcn_probe-{digest.hexdigest()[:16]}"


def find_or_build_binary() -> Path:
    """PATH → the library directory's build of this source → build it
    there with g++ (read-only source, atomic rename: concurrent builds
    each write their own temporary file)."""
    on_path = shutil.which("dcn_probe")
    if on_path:
        return Path(on_path)
    if not SOURCE.exists():
        raise DcnProbeError(f"dcn_probe source not found at {SOURCE}")
    binary = binary_path()
    if binary.exists():
        return binary
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise DcnProbeError("no C++ compiler available to build dcn_probe")
    binary.parent.mkdir(parents=True, exist_ok=True)
    tmp = binary.with_name(f"{binary.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([gxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True)
        os.replace(tmp, binary)
    finally:
        tmp.unlink(missing_ok=True)
    return binary


def free_base_port(world: int, *, attempts: int = 50) -> int:
    """A base port whose ``world`` ports (``base + rank``, where each rank
    listens) are free on this host now."""
    for _ in range(attempts):
        socks = []
        try:
            first = socket.socket()
            socks.append(first)
            first.bind(("127.0.0.1", 0))
            base = first.getsockname()[1]
            if base + world > 65536:
                continue
            for offset in range(1, world):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", base + offset))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise DcnProbeError(f"no {world} consecutive free ports found")


def _argv(binary: Path, rank: int, world: int, peers: list[str],
          base_port: int, mbytes: float, iters: int) -> list[str]:
    return [str(binary), "--rank", str(rank), "--world", str(world),
            "--peers", ",".join(peers), "--base-port", str(base_port),
            "--mbytes", str(mbytes), "--iters", str(iters)]


def run_rank(
    rank: int,
    world: int,
    peers: list[str],
    *,
    base_port: int = 19000,
    mbytes: float = 64.0,
    iters: int = 8,
    timeout: float = 120.0,
) -> dict:
    """Run this node's rank; blocks until the ring completes."""
    binary = find_or_build_binary()
    proc = subprocess.run(
        _argv(binary, rank, world, peers, base_port, mbytes, iters),
        capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise DcnProbeError(f"rank {rank} failed: {proc.stderr.strip()}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def run_local_ring(
    world: int = 2, *, mbytes: float = 32.0, iters: int = 4,
    base_port: int = 19000,
) -> list[dict]:
    """All ranks as local subprocesses (tests / single-host sanity)."""
    binary = find_or_build_binary()
    peers = ["127.0.0.1"] * world
    procs = [
        subprocess.Popen(
            _argv(binary, rank, world, peers, base_port, mbytes, iters),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)
    ]
    reports = []
    errors = []
    try:
        for rank, proc in enumerate(procs):
            out, err = proc.communicate(timeout=120)
            if proc.returncode != 0:
                errors.append(f"rank {rank}: {err.strip()}")
            else:
                reports.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    if errors:
        raise DcnProbeError("; ".join(errors))
    return reports


def _node_leader() -> bool:
    """Only a node's first process takes part in a ring; its other
    per-card processes would collide on the ring's ports."""
    return os.environ.get("LOCAL_RANK", "0") == "0"


def worker_env_config() -> tuple[int, int, list[str]] | None:
    """(rank, world, peers) of the slice's ring from the node env, or None
    off-slice and on a node's other per-card processes."""
    hostnames = os.environ.get("TPU_WORKER_HOSTNAMES", "")
    worker_id = os.environ.get("TPU_WORKER_ID", "")
    if not hostnames or not worker_id.isdigit() or not _node_leader():
        return None
    peers = hostnames.split(",")
    return int(worker_id), len(peers), peers


def slice_env_config() -> tuple[int, int, list[str]] | None:
    """(rank, world, peers) of the CROSS-SLICE ring: one rank per slice
    (node 0 of each), peers from ``KFTPU_SLICE_PEERS``, which
    ``MultiSlice.worker_env`` bakes into multislice StatefulSets.

    Returns None off-multislice, on a non-zero node, and on a node's other
    per-card processes."""
    peers = os.environ.get(SLICE_PEERS_ENV, "")
    slice_id = os.environ.get("MEGASCALE_SLICE_ID", "")
    worker_id = os.environ.get("TPU_WORKER_ID", "0")
    if not peers or not slice_id.isdigit() or worker_id != "0" \
            or not _node_leader():
        return None
    peer_list = peers.split(",")
    return int(slice_id), len(peer_list), peer_list
