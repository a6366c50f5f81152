"""In-notebook client: slice introspection, distributed bootstrap, and
preemption-aware checkpointing.

The port of ``kubeflow_tpu/sdk.py``. Everything a notebook needs to act on
the control plane's wiring, with zero configuration — every input is env
the controller/webhook injected or in-cluster credentials the pod
already has::

    from kubeflow_tpu_torch import sdk

    info = sdk.SliceInfo.from_env()       # who am I in the slice?
    sdk.initialize_distributed()          # init_process_group from env

    mgr = sdk.CheckpointManager("/home/jovyan/ckpt",
                                save_interval_steps=100)
    guard = sdk.CheckpointGuard(mgr)
    for step in range(start, n_steps):
        state, loss = train_step(state, batch)
        guard.step(step, trainer.checkpoint_tree(state))

What has no JAX in it is copied: ``SliceInfo`` (the same env names),
``MaintenanceWatcher``, ``suspend``/``resume``, the in-cluster fetch and
patch, ``telemetry_publisher`` and the guard's drain protocol. What runs
on the device is torch's:

- ``initialize_distributed`` calls ``init_process_group`` from the GPU
  node env (``gpu/topology.py``: one process per card, torchrun's names)
  or the JAX package's (``JAX_COORDINATOR_ADDRESS``,
  ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``): NCCL on the card, where it
  sets this process's device, gloo only for ``device="cpu"``;
- ``trace`` and ``capture_profile`` are ``torch.profiler`` contexts whose
  ``tensorboard_trace_handler`` writes under the same logdir;
- ``CheckpointGuard`` agrees on the drain and maintenance verdict by a
  broadcast from rank 0 on a gloo group of its own, and process 0 is the
  one writer of annotations;
- ``warm_idle`` enables and seeds the kernel cache
  (``utils/compilecache``), attaches the card and builds the kernels (the
  port's compile phase) before it parks.

- ``start_profiler_server`` serves the TF profiler's gRPC
  (``tensorflow.ProfilerService``, what TensorBoard's capture button
  calls) from this package's own server (``profiler/``: torch serves no
  such thing, so the port carries one, as jaxlib carries the
  reference's), recording with ``torch.profiler``: the capture's
  ``XSpace`` holds the card's kernels.
"""

from __future__ import annotations

import json
import logging
import os
import ssl
import threading
import time
import urllib.request
from dataclasses import dataclass

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.api import keys
from kubeflow_tpu_torch.api.notebook import (
    DRAIN_REQUESTED_ANNOTATION,
    MAINTENANCE_ANNOTATION,
    SUSPEND_ANNOTATION,
)
from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.gpu import topology as _gpu
from kubeflow_tpu_torch.migration import protocol as _migration
from kubeflow_tpu_torch.utils.checkpoint import CheckpointManager

__all__ = [
    "CheckpointGuard",
    "CheckpointManager",
    "MaintenanceWatcher",
    "SliceInfo",
    "capture_profile",
    "initialize_distributed",
    "resume",
    "start_profiler_server",
    "suspend",
    "telemetry_publisher",
    "trace",
    "warm_idle",
]

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
_log = logging.getLogger(__name__)


@dataclass(frozen=True)
class SliceInfo:
    """This worker's place in the slice/multislice, parsed from the env
    contract of ``gpu/topology.py`` (``GpuSlice.worker_env`` /
    ``MultiSlice.worker_env``, the per-ordinal ``PET_NODE_RANK``).

    The process space is read in this order: a ``torchrun`` child's
    ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR:MASTER_PORT``; else the
    node's env (``PET_NNODES`` ...), where a process launched per card
    sets ``LOCAL_RANK`` and is rank ``node_rank * cards_per_node +
    LOCAL_RANK`` of ``nodes * cards_per_node``, and a process without
    ``LOCAL_RANK`` is its node's one rank; else the JAX package's names
    (``JAX_PROCESS_ID`` ...), as the reference reads them."""

    worker_id: int
    num_workers: int
    hostnames: tuple[str, ...]
    process_id: int
    num_processes: int
    coordinator_address: str | None
    slice_id: int
    num_slices: int
    accelerator_type: str | None
    topology: str | None
    namespace: str | None
    notebook: str | None

    @classmethod
    def from_env(cls, environ=os.environ) -> "SliceInfo":
        hostnames = tuple(
            h for h in (environ.get("TPU_WORKER_HOSTNAMES") or "").split(",")
            if h
        )
        ns = name = None
        prefix = environ.get("NB_PREFIX") or ""
        parts = prefix.strip("/").split("/")
        if len(parts) == 3 and parts[0] == "notebook":
            ns, name = parts[1], parts[2]
        worker_id = int(environ.get("TPU_WORKER_ID") or 0)
        process_id, num_processes, coordinator = _process_space(
            environ, worker_id, max(len(hostnames), 1))
        return cls(
            worker_id=worker_id,
            num_workers=max(len(hostnames), 1),
            hostnames=hostnames,
            process_id=process_id,
            num_processes=num_processes,
            coordinator_address=coordinator,
            slice_id=int(environ.get("MEGASCALE_SLICE_ID") or 0),
            num_slices=int(environ.get("MEGASCALE_NUM_SLICES") or 1),
            accelerator_type=environ.get("TPU_ACCELERATOR_TYPE"),
            topology=environ.get("TPU_TOPOLOGY"),
            namespace=ns,
            notebook=name,
        )

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def _address(host: str | None, port: str | None) -> str | None:
    return f"{host}:{port}" if host and port else None


def _process_space(environ, worker_id: int,
                   num_workers: int) -> tuple[int, int, str | None]:
    """``(rank, world size, rendezvous host:port)`` of this process, in
    :class:`SliceInfo`'s order of env contracts."""
    if environ.get("RANK") and environ.get("WORLD_SIZE"):
        return (int(environ["RANK"]), int(environ["WORLD_SIZE"]),
                _address(environ.get("MASTER_ADDR"),
                         environ.get("MASTER_PORT")))
    if environ.get(_gpu.NNODES_ENV):
        nodes = int(environ[_gpu.NNODES_ENV])
        node = int(environ.get(_gpu.NODE_RANK_ENV) or 0)
        address = _address(environ.get(_gpu.MASTER_ADDR_ENV),
                           environ.get(_gpu.MASTER_PORT_ENV))
        local = environ.get("LOCAL_RANK")
        if local is None:
            return node, nodes, address
        per_node = int(environ.get(_gpu.NPROC_PER_NODE_ENV) or 1)
        if not 0 <= int(local) < per_node:
            raise ValueError(f"LOCAL_RANK {local} outside the node's "
                             f"{per_node} processes")
        return node * per_node + int(local), nodes * per_node, address
    return (int(environ.get("JAX_PROCESS_ID") or worker_id),
            int(environ.get("JAX_NUM_PROCESSES") or num_workers),
            environ.get("JAX_COORDINATOR_ADDRESS"))


def initialize_distributed(environ=os.environ, *, device=None) -> bool:
    """``torch.distributed.init_process_group`` from the injected env.
    Returns True when a multi-process world was initialized, False for
    the single-host no-op (so the same notebook code runs on one card and
    on many). Idempotent: a second call is a no-op.

    On the card (``device=None``) the group is NCCL and this process takes
    card ``LOCAL_RANK`` (default: its process id modulo the cards it
    sees); without a card it raises. ``device="cpu"`` forms a gloo group.
    The coordinator address (``host:port``) is the TCP rendezvous; under
    ``torchrun`` (``TORCHELASTIC_USE_AGENT_STORE``) the agent already
    serves the store there, and the group joins it through ``env://``."""
    dev = resolve_device(device)
    info = SliceInfo.from_env(environ)
    if info.num_processes <= 1 or not info.coordinator_address:
        return False
    if dist.is_initialized():
        return True  # already initialized
    if dev.type == "cuda":
        local = environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else info.process_id % torch.cuda.device_count())
    agent_store = environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=("env://" if agent_store
                     else f"tcp://{info.coordinator_address}"),
        world_size=info.num_processes, rank=info.process_id)
    return True


PROFILER_PORT = 9999
_profiler_port: int | None = None
_profiler_server = None


def start_profiler_server(port: int = PROFILER_PORT, *, device=None) -> None:
    """The TF profiler's gRPC service on the conventional port — the target
    of TensorBoard's profile-plugin "capture" button (SURVEY §5: the
    ``jax.profiler.start_server`` convention in images). Point a
    ``Tensorboard`` CR with ``spec.profilerPlugin: true`` at the
    notebook's DNS name to capture live: the capture records, with
    ``torch.profiler``, the card's kernels and every thread's CUDA runtime
    calls, but the ops of the server's own thread only
    (``kubeflow_tpu_torch.profiler.server`` says why). Idempotent:
    re-running the setup cell is a no-op (one server per process). Runs
    for the card; ``device="cpu"`` records every thread's ops on the
    host, and without a card and without it the call raises."""
    global _profiler_port, _profiler_server
    if _profiler_port is not None:
        if _profiler_port >= 0 and port != _profiler_port:
            # One server per process; a move is impossible — say so
            # instead of silently ignoring the new port.
            _log.warning(
                "profiler server already on port %d; cannot move to %d "
                "(one server per process)", _profiler_port, port)
        return
    from kubeflow_tpu_torch.profiler.server import ProfilerServer

    try:
        _profiler_server = ProfilerServer(port, device=device)
        _profiler_port = port
    except ValueError:
        # A server already runs in this process (started outside the
        # sdk) — on an unknown port, so record the sentinel rather than
        # a port we can't confirm (a later mismatch warning would state
        # the inverse of reality).
        _log.warning("profiler server already running; reusing it")
        _profiler_port = -1


def trace(logdir: str, *, device=None):
    """Context manager writing a ``torch.profiler`` trace under ``logdir``
    (``tensorboard_trace_handler``, one ``*.pt.trace.json`` a capture) —
    served by a ``Tensorboard`` CR with ``spec.profilerPlugin: true``
    over the same PVC path (``kubeflow_tpu_torch.controllers.tensorboard``)::

        with sdk.trace("/home/jovyan/logs"):
            state, loss = train_step(state, batch)
            torch.cuda.synchronize()

    Records the card's kernels and the host's ops (``device="cpu"``: the
    host's alone); without a card and without ``device="cpu"`` it
    raises. On the card the window opens only after :func:`_warm_up_cupti`
    has run, so the block's first kernels are in the trace."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    dev = resolve_device(device)
    handler = tensorboard_trace_handler(logdir)
    if dev.type != "cuda":
        return profile(activities=[ProfilerActivity.CPU],
                       on_trace_ready=handler)
    return _WarmedProfile(
        dev, activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        on_trace_ready=handler)


def _warm_up_cupti(device) -> None:
    """Kernels on ``device`` between enabling CUPTI's activity records and
    opening the trace's window. On an H100 (torch 2.11.0+cu128) a session
    opened after the card had idled for 20-30 s lost the records of the
    kernels of its first ~1 ms (1-15 kernels, more the longer the process
    had run); with these kernels in front, none was lost (PERF.md §6).
    kineto drops what precedes the window, so they are not in the trace."""
    with torch.cuda.device(device):
        torch.cuda._sleep(2_000_000)          # ~1 ms of one spinning thread
        x = torch.ones(16, device=device)
        for _ in range(16):
            x.add_(1.0)
        torch.cuda.synchronize(device)


class _WarmedProfile(torch.profiler.profile):
    """``torch.profiler.profile`` whose ``prepare_trace`` (CUPTI enabled,
    the window not yet open) ends with :func:`_warm_up_cupti` on
    ``card``."""

    def __init__(self, card, **kwargs):
        super().__init__(**kwargs)
        self.card = card

    def prepare_trace(self):
        super().prepare_trace()
        _warm_up_cupti(self.card)


# Where capture_profile() writes when the caller doesn't say: the same
# path the notebook images mount for TensorBoard logs, so a Tensorboard
# CR with spec.profilerPlugin: true over the shared PVC/GCS prefix picks
# the trace up with no extra wiring (kubeflow_tpu_torch/controllers/
# tensorboard.py renders its Deployment over that logdir).
TELEMETRY_LOGDIR_ENV = "KFTPU_TELEMETRY_LOGDIR"
DEFAULT_TRACE_LOGDIR = "/home/jovyan/logs"


def capture_profile(logdir: str | None = None, *, environ=os.environ,
                    device=None):
    """Context manager dumping a ``torch.profiler`` trace where the
    Tensorboard CR can serve it — :func:`trace` with the logdir resolved
    from ``KFTPU_TELEMETRY_LOGDIR`` (controller-injectable) and falling
    back to the images' TensorBoard log mount::

        with sdk.capture_profile():
            state, loss = train_step(state, batch)
            torch.cuda.synchronize()

    Point a ``Tensorboard`` CR with ``spec.profilerPlugin: true`` at the
    same PVC/GCS path to browse the trace (docs/operations.md "Training
    telemetry & profiler traces")."""
    if logdir is None:
        logdir = environ.get(TELEMETRY_LOGDIR_ENV) or DEFAULT_TRACE_LOGDIR
    return trace(logdir, device=device)


def telemetry_publisher(*, environ=os.environ, patcher=None, registry=None):
    """Build a :class:`kubeflow_tpu_torch.telemetry.TelemetryPublisher` writing
    to this notebook's own CR (the write half mirrors the drain-ack
    transport: stdlib-only, ServiceAccount-credentialed). Pass the result
    as ``trainer.fit(..., publisher=...)`` next to a ``StepProfiler``.
    Raises ValueError outside the controller's env unless ``patcher`` is
    given (tests inject a recorder taking the full merge-patch body)."""
    from kubeflow_tpu_torch.telemetry import TelemetryPublisher

    if patcher is None:
        annotations_patcher = _identity_patcher(environ)

        def patcher(body: dict) -> None:
            annotations_patcher(
                (body.get("metadata") or {}).get("annotations") or {})

    return TelemetryPublisher(patcher, registry=registry, environ=environ)


def _in_cluster_fetch(namespace: str, name: str):
    """Build a () -> annotations fetcher reading this notebook's CR via the
    in-cluster apiserver with the pod's ServiceAccount (stdlib-only — a
    notebook image need not carry an HTTP client library)."""
    host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    if ":" in host and not host.startswith("["):
        host = f"[{host}]"  # bare IPv6 apiserver address (IPv6-only clusters)
    url = (f"https://{host}:{port}{keys.NOTEBOOKS_API_PATH_PREFIX}"
           f"{namespace}/notebooks/{name}")
    ctx = ssl.create_default_context(cafile=os.path.join(_SA_DIR, "ca.crt"))

    def fetch() -> dict:
        with open(os.path.join(_SA_DIR, "token")) as f:
            token = f.read().strip()
        req = urllib.request.Request(
            url, headers={"Authorization": f"Bearer {token}"})
        with urllib.request.urlopen(req, context=ctx, timeout=10) as resp:
            obj = json.loads(resp.read())
        return (obj.get("metadata") or {}).get("annotations") or {}

    return fetch


def _in_cluster_url(namespace: str, name: str) -> str:
    host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    if ":" in host and not host.startswith("["):
        host = f"[{host}]"
    return (f"https://{host}:{port}{keys.NOTEBOOKS_API_PATH_PREFIX}"
            f"{namespace}/notebooks/{name}")


def _in_cluster_patcher(namespace: str, name: str):
    """Build an annotations-merge-patcher for this notebook's own CR —
    the write half of the drain protocol (checkpoint ack, suspend). Same
    stdlib-only, ServiceAccount-credentialed transport as the fetch."""
    url = _in_cluster_url(namespace, name)
    ctx = ssl.create_default_context(cafile=os.path.join(_SA_DIR, "ca.crt"))

    def patch_annotations(annotations: dict) -> None:
        with open(os.path.join(_SA_DIR, "token")) as f:
            token = f.read().strip()
        body = json.dumps(
            {"metadata": {"annotations": annotations}}).encode()
        req = urllib.request.Request(
            url, data=body, method="PATCH",
            headers={
                "Authorization": f"Bearer {token}",
                "Content-Type": "application/merge-patch+json",
            })
        with urllib.request.urlopen(req, context=ctx, timeout=10) as resp:
            resp.read()

    return patch_annotations


def _identity_patcher(environ=os.environ):
    info = SliceInfo.from_env(environ)
    if not (info.namespace and info.notebook):
        raise ValueError(
            "not running under the controller (no NB_PREFIX); "
            "pass patcher= explicitly")
    return _in_cluster_patcher(info.namespace, info.notebook)


def suspend(*, environ=os.environ, patcher=None) -> None:
    """Ask the control plane to checkpoint-and-park this notebook: stamps
    the suspend annotation; the notebook controller requests a drain, the
    training loop's CheckpointGuard acks it, and the server parks with
    "Suspended (checkpoint @ step N)". Resume with :func:`resume` (before
    the park completes), ``kubectl annotate notebook <name>
    notebooks.kubeflow.org/suspend-``, or the UI's start button."""
    import datetime

    patcher = patcher or _identity_patcher(environ)
    patcher({SUSPEND_ANNOTATION: datetime.datetime.now(
        datetime.timezone.utc).isoformat()})


def resume(*, environ=os.environ, patcher=None) -> None:
    """Clear the suspend annotation: cancels a drain still in flight; a
    notebook already parked un-parks on the controller's next reconcile
    and restores from its checkpoint hint."""
    patcher = patcher or _identity_patcher(environ)
    patcher({SUSPEND_ANNOTATION: None})


# ---- warm pod pools (the JAX package's controllers/warmpool.py) -------------

# Env contract of the warm-idle shim (docs/operations.md "Warm pools &
# cold-start"). WARM_IDLE_ENV is also stamped by the pool controller's
# slot template (controllers/warmpool.py keeps a matching constant).
WARM_IDLE_ENV = "KFTPU_WARM_IDLE"
WARM_CLAIM_FILE_ENV = "KFTPU_WARM_CLAIM_FILE"
# Downward-API volume path the pool pod template mounts: pod annotations
# as `key="value"` lines, updated live — how the claim annotation reaches
# the shim without any apiserver credential.
DEFAULT_CLAIM_FILE = "/etc/podinfo/annotations"


def _read_downward_claim(path: str) -> str | None:
    """Parse the downward-API annotations file for the warm-claim
    annotation (``key="escaped value"`` lines)."""
    try:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
    except OSError:
        return None
    for line in text.splitlines():
        k, sep, v = line.partition("=")
        if not sep or k.strip() != keys.TPU_WARM_CLAIM:
            continue
        v = v.strip()
        if len(v) >= 2 and v.startswith('"') and v.endswith('"'):
            v = v[1:-1].encode().decode("unicode_escape")
        return v or None
    return None


def warm_idle(*, environ=os.environ, poll_seconds: float = 1.0,
              fetch_claim=None, init_devices: bool = True,
              max_wait: float | None = None, _sleep=time.sleep) -> str | None:
    """Hold a warm-pool pod fully started until it is claimed.

    This is what makes a warm pod actually WARM: the kernel cache is
    enabled and seeded from the image's libraries
    (``utils/compilecache.seed_cache``), the card is attached and the
    port's kernels are built (``ops._build.build``: the nvcc runs a cold
    pod pays at its first launch, none where the seed holds them), so a
    claimed pod has already paid the interpreter, import, device-attach
    and kernel-build phases of the cold-start waterfall. Then it parks, polling the downward-API
    annotations file for the claim annotation the claim protocol stamps
    (:data:`kubeflow_tpu_torch.api.keys.TPU_WARM_CLAIM`). Returns the claim
    value (``"<ns>/<name>/<nonce>"``) — the shim then execs the real
    notebook server with the injected env — or None when ``max_wait``
    expires (tests; production pods wait forever)."""
    from kubeflow_tpu_torch.utils import compilecache

    cache_dir = compilecache.enable_persistent_cache()
    seeded = compilecache.seed_cache(cache_dir=cache_dir)
    _log.info(
        "warm idle: kernel cache %s ready=%s (seeded %d, skipped %d)",
        cache_dir, seeded["ready"], seeded["seeded"], seeded["skipped"])
    if init_devices:
        try:
            from kubeflow_tpu_torch.ops import _build

            torch.cuda.init()  # attach the card
            built = _build.build()
            _log.info("warm idle: card attached, %d kernel sources built",
                      len(built))
        except Exception:  # noqa: BLE001 — a warm pod without a card or
            # nvcc is still warm for interpreter+imports; claiming it
            # beats cold.
            _log.warning("warm idle: card attach or kernel build failed; "
                         "staying warm for interpreter/imports only",
                         exc_info=True)
    if fetch_claim is None:
        path = environ.get(WARM_CLAIM_FILE_ENV) or DEFAULT_CLAIM_FILE

        def fetch_claim(path=path):
            return _read_downward_claim(path)

    t0 = time.monotonic()
    while True:
        try:
            claim = fetch_claim()
        except Exception:  # noqa: BLE001 — a flaky read must not kill the
            # warm pod; the next poll retries.
            _log.debug("warm-idle claim poll failed", exc_info=True)
            claim = None
        if claim:
            return claim
        if max_wait is not None and time.monotonic() - t0 >= max_wait:
            return None
        _sleep(poll_seconds)


class MaintenanceWatcher:
    """Polls this notebook's CR for the controller's maintenance-pending
    annotation. ``check()`` for in-loop use (CheckpointGuard), or
    ``start(callback)`` for a daemon thread that fires once per
    pending-transition with the affected node list."""

    def __init__(self, fetch=None, *, interval: float = 30.0,
                 environ=os.environ):
        if fetch is None:
            info = SliceInfo.from_env(environ)
            if not (info.namespace and info.notebook):
                raise ValueError(
                    "not running under the controller (no NB_PREFIX); "
                    "pass fetch= explicitly")
            fetch = _in_cluster_fetch(info.namespace, info.notebook)
        self._fetch = fetch
        self.interval = interval
        self._last: str | None = None
        self._last_at = 0.0
        # Full annotation snapshot from the last successful fetch: the
        # drain protocol (CheckpointGuard) reads more than the
        # maintenance key from the same rate-limited poll.
        self._ann: dict = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def check(self, *, max_age: float | None = None) -> str | None:
        """Current pending-node list ("" semantics: None = clear). Rate
        limited to one apiserver GET per ``interval`` (or ``max_age``);
        between polls the cached answer is returned — cheap enough for a
        per-training-step call."""
        age_limit = self.interval if max_age is None else max_age
        now = time.monotonic()
        if now - self._last_at >= age_limit:
            self._last_at = now
            try:
                self._ann = self._fetch() or {}
                self._last = self._ann.get(MAINTENANCE_ANNOTATION) or None
            except Exception:  # noqa: BLE001 — a flaky apiserver read must
                # not take down the training loop; serve the cached view.
                _log.debug("maintenance poll failed; keeping cached "
                           "annotations", exc_info=True)
        return self._last

    def annotations(self, *, max_age: float | None = None) -> dict:
        """The CR's annotations from the same rate-limited cache as
        ``check()`` — the drain/suspend protocol reads its request marks
        here. Last-known-good on fetch errors, like ``check()``."""
        self.check(max_age=max_age)
        return self._ann

    def _poll(self, stop: threading.Event) -> str | None:
        """The poller thread's fetch. Commits to the shared check() cache
        only while this generation is live — a stopped generation's
        wedged fetch returning late must not poison ``_last`` for direct
        check() callers (CheckpointGuard) or a successor poller."""
        try:
            ann = self._fetch() or {}
            val = ann.get(MAINTENANCE_ANNOTATION) or None
        except Exception:  # noqa: BLE001 — same policy as check()
            return self._last
        if not stop.is_set():
            self._ann = ann
            self._last = val
            self._last_at = time.monotonic()
        return val

    def start(self, callback) -> None:
        """callback(nodes: str) fires once each time maintenance becomes
        pending (not per poll). A callback exception is logged, not
        fatal — the watcher keeps watching (same policy as check()'s
        fetch errors). start() after stop() resumes watching; start()
        while already watching is a no-op (re-running a notebook cell
        must not stack a second poller)."""
        if self._thread is not None and self._thread.is_alive():
            return
        # Each generation gets ITS OWN event, bound into the closure: a
        # stop() whose join times out (fetch wedged) followed by start()
        # replaces self._stop — the old thread must keep seeing the set
        # event, or it would un-suppress and fire its stale callback
        # alongside the new poller.
        stop = self._stop = threading.Event()  # restartable after stop()

        def loop():
            armed = True
            # Poll before the first wait: a window already pending when the
            # watcher starts must fire now, not up to `interval` later —
            # that delay is exactly the time before a node termination.
            while True:
                if stop.is_set():
                    return  # stop() raced the first poll: no late fetch
                            # or callback on torn-down state
                pending = self._poll(stop)
                if stop.is_set():
                    return  # stop() landed mid-fetch: no late callback
                if pending and armed:
                    armed = False
                    try:
                        callback(pending)
                    except Exception:  # noqa: BLE001
                        _log.exception(
                            "maintenance callback failed; still watching")
                elif not pending:
                    armed = True
                if stop.wait(self.interval):
                    return

        self._thread = threading.Thread(
            target=loop, name="kftpu-maintenance-watch", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# Coordinated-signal bits (one broadcast carries both verdicts).
_MAINTENANCE_BIT = 1
_DRAIN_BIT = 2


class CheckpointGuard:
    """Checkpoint on the manager's schedule — and immediately when the
    control plane says the slice is about to lose a node, or asks the
    gang to drain (preemption, idle cull, user suspend).

    Wraps checkpoint.CheckpointManager: ``step()`` defers scheduled
    saves to the manager (its ``save_interval_steps`` is the one cadence
    knob), and forces an out-of-schedule save (then blocks until it
    commits) the first time the maintenance annotation appears. One
    forced save per pending-transition — a long maintenance window
    doesn't re-save every step.

    **Drain protocol** (migration/protocol.py): when the drain-requested
    annotation appears, the guard saves immediately and **acks** by
    patching the checkpointed-at / path / step annotations onto its own
    CR — the control plane then parks the gang and, on re-admission,
    stamps the same path/step back into the pod env as the restore hint.
    With a :class:`kubeflow_tpu_torch.checkpoint.CheckpointFabric` manager the
    save is snapshot-then-ack: the ack goes out as soon as device arrays
    are copied to host, the background uploader finishes during graceful
    termination, and the durable-commit mark
    (``checkpoint-committed-at``) lands when the manifest does — call
    :meth:`close` (or use the guard as a context manager) so teardown
    blocks on the commit. With a plain CheckpointManager the legacy
    synchronous save-wait-ack runs and the ack carries the commit mark.
    After the ack the loop may keep stepping; the park arrives as a
    normal scale-to-zero. ``drained`` reports that this guard has
    committed an ack.

    **Multi-process:** a DCP save is a collective — every process must
    save the *same* step. Per-worker watchers poll on their own clocks,
    so the pending/drain decision is made by rank 0 alone and broadcast
    to the others on a gloo group of the guard's own every
    ``sync_every_steps`` steps. Every process constructs the guard (the
    group's creation is a collective) and calls ``step()`` with the same
    step number (the normal SPMD loop); the broadcast only runs on sync
    steps, so its cost amortizes. Without a process group (one process)
    the guard checks locally; a broadcast that fails degrades to
    local-only checks instead of raising into the training loop."""

    def __init__(self, manager: CheckpointManager,
                 watcher: MaintenanceWatcher | None = None, *,
                 sync_every_steps: int = 16, environ=os.environ,
                 patcher=None):
        self.manager = manager
        self.watcher = watcher or MaintenanceWatcher(environ=environ)
        self.sync_every_steps = max(1, sync_every_steps)
        self._armed = True
        self._drain_armed = True
        self._environ = environ
        self._patcher = patcher
        self._ack_pending_step: int | None = None
        # Durable-commit patch that failed (flaky apiserver) — retried on
        # sync steps and flushed by close(), like the ack retry. Holds
        # (for_request,) so an echo-less retry is still distinguishable
        # from "nothing pending".
        self._commit_pending: tuple[str | None] | None = None
        self._restore_tier_stamped = False
        self._progress_last = 0.0
        self._warned_local_only = False
        self.drained = False
        self._group = (dist.new_group(backend="gloo")
                       if dist.is_initialized()
                       and dist.get_world_size() > 1 else None)

    @property
    def _fabric(self) -> bool:
        """Snapshot-then-ack is available when the manager speaks the
        checkpoint fabric's async surface."""
        return hasattr(self.manager, "save_async")

    def _local_signals(self) -> int:
        ann = self.watcher.annotations()
        bits = 0
        if ann.get(MAINTENANCE_ANNOTATION):
            bits |= _MAINTENANCE_BIT
        if (ann.get(DRAIN_REQUESTED_ANNOTATION)
                and not _migration.drain_acked(ann)):
            bits |= _DRAIN_BIT
        return bits

    def _signals_coordinated(self) -> int:
        """Rank 0's watcher verdict (maintenance + drain bits), agreed on
        by every process through a broadcast on the guard's gloo group —
        degrading to this process's own local check without a group (one
        process) or when the broadcast fails: a broken collective must
        never raise into the training loop, and local-only checks still
        converge because every worker polls the same CR."""
        if self._group is None:
            return self._local_signals()
        rank = dist.get_rank()
        local = self._local_signals() if rank == 0 else 0
        try:
            word = torch.tensor([local], dtype=torch.int32)
            dist.broadcast(word, src=dist.get_global_rank(self._group, 0),
                           group=self._group)
            return int(word.item())
        except Exception:  # noqa: BLE001 — a broken group
            if not self._warned_local_only:
                self._warned_local_only = True
                _log.warning(
                    "multi-process coordination unavailable; degrading to "
                    "local-only maintenance/drain checks")
            return self._local_signals()

    def _pending_coordinated(self) -> bool:
        """Back-compat shim: the maintenance bit of the coordinated
        signals."""
        return bool(self._signals_coordinated() & _MAINTENANCE_BIT)

    def _is_writer(self) -> bool:
        """Annotation patches are rank-0 only — one writer."""
        return not dist.is_initialized() or dist.get_rank() == 0

    def _try_ack(self, step: int, *, committed: bool = False) -> None:
        """Patch the checkpoint ack onto this notebook's CR (process 0
        only — one writer). Failure re-arms the pending ack; the next
        sync step retries without re-saving. ``committed=True`` (the
        synchronous legacy path, where the save is already durable when
        the ack goes out) folds the commit mark into the same patch; the
        fabric path stamps it separately from the uploader's commit
        callback."""
        if not self._is_writer():
            self._ack_pending_step = None
            return
        if self._patcher is None:
            try:
                self._patcher = _identity_patcher(self._environ)
            except ValueError:
                _log.warning("cannot ack drain: no notebook identity and "
                             "no patcher provided")
                self._ack_pending_step = None
                return
        directory = getattr(self.manager, "directory", "") or ""
        # Echo the request being answered: ack detection compares the
        # echo, not timestamps from two different clocks (pod vs
        # controller — skew must not make acks invisible).
        for_request = self.watcher.annotations().get(
            DRAIN_REQUESTED_ANNOTATION)
        now = time.time()
        patch = _migration.ack_patch(
            directory, step, now, for_request=for_request)
        if committed:
            patch.update(_migration.commit_patch(
                now, for_request=for_request))
        try:
            self._patcher(patch)
            self._ack_pending_step = None
        except Exception:  # noqa: BLE001 — flaky apiserver; retry later
            _log.warning("drain ack patch failed; retrying next sync step")
            self._ack_pending_step = step

    def _try_commit_mark(self, for_request: str | None) -> None:
        """Stamp the durable-commit mark (fabric uploader callback, or a
        sync-step / close() retry after a failed stamp)."""
        if not self._is_writer() or self._patcher is None:
            self._commit_pending = None
            return
        try:
            self._patcher(_migration.commit_patch(
                time.time(), for_request=for_request))
            self._commit_pending = None
        except Exception:  # noqa: BLE001 — flaky apiserver; retry later
            _log.warning("checkpoint commit mark failed; retrying")
            self._commit_pending = (for_request,)

    def _mark_progress(self, done: int, total: int) -> None:
        """Best-effort, rate-limited "k/N chunks" progress mark (JWA's
        parked-uncommitted message). Runs on the uploader thread."""
        if not self._is_writer() or self._patcher is None:
            return
        now = time.monotonic()
        if done < total and now - self._progress_last < 0.5:
            return
        self._progress_last = now
        try:
            self._patcher(_migration.progress_patch(done, total))
        except Exception:  # noqa: BLE001 — purely a UI progress mark
            _log.debug("upload progress mark failed (best-effort)",
                       exc_info=True)

    def _mark_checkpointing(self) -> None:
        """Best-effort progress mark so the UI can say "Checkpointing…"
        while a large snapshot streams out."""
        if self._patcher is None:
            try:
                self._patcher = _identity_patcher(self._environ)
            except ValueError:
                return
        import datetime

        try:
            self._patcher({
                keys.NOTEBOOK_CHECKPOINTING_AT:
                    datetime.datetime.now(
                        datetime.timezone.utc).isoformat()})
        except Exception:  # noqa: BLE001 — purely a UI progress mark
            _log.debug("checkpointing-at progress mark failed "
                       "(best-effort)", exc_info=True)

    def _drain_save(self, step: int, pytree) -> bool:
        """One drain checkpoint. With the fabric: snapshot-then-ack —
        ``save_async`` returns once device arrays are copied to host, the
        ack goes out immediately, and the uploader's commit callback
        stamps the durable-commit mark when the manifest lands (the
        scheduler's commit wait watches for it). Without the fabric:
        the legacy synchronous save-wait-ack, with the commit mark folded
        into the ack (the save IS durable by then)."""
        if not self._fabric:
            saved = self.manager.save(step, pytree, force=True)
            self.manager.wait()  # the ack promises a COMMITTED save
            self._try_ack(step, committed=True)
            return saved
        # Echo captured NOW: the commit must answer the drain that
        # triggered this save even if a new drain lands mid-upload.
        for_request = self.watcher.annotations().get(
            DRAIN_REQUESTED_ANNOTATION)
        self.manager.save_async(
            step, pytree,
            on_progress=self._mark_progress,
            on_commit=lambda _step, _secs:
                self._try_commit_mark(for_request))
        self._try_ack(step)  # snapshot done — ack before the upload
        return True

    def _mark_restore_tier(self) -> None:
        """Best-effort, once: record which tier served the fabric's
        restore ("staging" / "remote") so JWA can say "Restoring from
        local staging tier" vs "…from object storage"."""
        self._restore_tier_stamped = True
        last = getattr(self.manager, "last_restore", None)
        if not last or not last.get("tier"):
            return
        if not self._is_writer() or self._patcher is None:
            return
        try:
            self._patcher(_migration.restore_tier_patch(last["tier"]))
        except Exception:  # noqa: BLE001 — purely a UI mark
            _log.debug("restore tier mark failed (best-effort)",
                       exc_info=True)

    def step(self, step: int, pytree) -> bool:
        if step % self.sync_every_steps == 0:
            if not self._restore_tier_stamped:
                self._mark_restore_tier()
            if self._ack_pending_step is not None:
                self._try_ack(self._ack_pending_step)
            if self._commit_pending is not None:
                self._try_commit_mark(self._commit_pending[0])
            signals = self._signals_coordinated()
            if signals & _DRAIN_BIT:
                if self._drain_armed:
                    self._drain_armed = False
                    self._mark_checkpointing()
                    saved = self._drain_save(step, pytree)
                    self.drained = True
                    return saved
            else:
                self._drain_armed = True
            if signals & _MAINTENANCE_BIT:
                if self._armed:
                    self._armed = False
                    saved = self.manager.save(step, pytree, force=True)
                    self.manager.wait()  # commit before the node goes away
                    return saved
            else:
                self._armed = True
        return self.manager.save(step, pytree)

    def close(self) -> None:
        """Teardown: block until any in-flight async save durably
        commits (the fabric's close() waits on its uploader, leaving no
        orphaned temp files), then flush a commit mark whose patch
        failed. Safe to call twice; the graceful-termination path after
        a park runs this so the upload outlives the ack."""
        close = getattr(self.manager, "close", None)
        if callable(close):
            close()
        if self._commit_pending is not None:
            self._try_commit_mark(self._commit_pending[0])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _main() -> None:
    """``python -m kubeflow_tpu_torch.sdk`` — print this worker's slice
    identity as one JSON line. ``--warm-idle`` runs the warm-pool hold
    loop instead (the pool controller's slot pod command)."""
    import dataclasses
    import json
    import sys

    if "--warm-idle" in sys.argv[1:]:
        claim = warm_idle()
        print(json.dumps({"claimed": claim}))
        return
    print(json.dumps(dataclasses.asdict(SliceInfo.from_env())))


if __name__ == "__main__":
    _main()
