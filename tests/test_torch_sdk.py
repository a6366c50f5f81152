"""The port's in-notebook SDK (``kubeflow_tpu_torch.sdk``) against the JAX
package's (``kubeflow_tpu.sdk``).

The copied parts give what the reference gives on the same inputs: the
slice identity from the same env, the wire names, the drain protocol's
patches. The guard, driven through the same annotations by both packages,
sends the same sequence of patches (timestamps aside). What runs on
torch: ``initialize_distributed`` forms a gloo world from the env,
``trace`` writes a ``torch.profiler`` trace under the logdir, and two
guards in a world of 2 save at the step rank 0's drain signal names.
"""

import dataclasses
import inspect
import json
import multiprocessing
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from kubeflow_tpu import sdk as jax_sdk
from kubeflow_tpu.api import keys as jax_keys
from kubeflow_tpu.api import notebook as jax_nb
from kubeflow_tpu.migration import protocol as jax_protocol
from kubeflow_tpu.runtime import objects as jax_objects
from kubeflow_tpu_torch import sdk
from kubeflow_tpu_torch.api import keys, notebook
from kubeflow_tpu_torch.checkpoint import CheckpointFabric
from kubeflow_tpu_torch.migration import protocol
from kubeflow_tpu_torch.parallel.launch import run_world
from kubeflow_tpu_torch.runtime import objects
from kubeflow_tpu_torch.runtime.metrics import Registry
from kubeflow_tpu_torch.telemetry import TelemetryPublisher

torch.set_num_threads(1)

WORKER_ENV = {
    "TPU_WORKER_ID": "1",
    "TPU_WORKER_HOSTNAMES": "nb-0.nb-workers.team,nb-1.nb-workers.team",
    "TPU_ACCELERATOR_TYPE": "v5litepod-16",
    "TPU_TOPOLOGY": "4x4",
    "JAX_COORDINATOR_ADDRESS": "nb-0.nb-workers.team:8476",
    "JAX_NUM_PROCESSES": "2",
    "JAX_PROCESS_ID": "1",
    "NB_PREFIX": "/notebook/team/nb",
}
ENVS = [WORKER_ENV, {}, {"JAX_NUM_PROCESSES": "1"},
        dict(WORKER_ENV, MEGASCALE_SLICE_ID="1", MEGASCALE_NUM_SLICES="2",
             JAX_PROCESS_ID="3", JAX_NUM_PROCESSES="4"),
        {"NB_PREFIX": "/notebook/ns"}, {"TPU_WORKER_HOSTNAMES": "a,,b"}]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_slice_info_equals_the_reference(env):
    got = sdk.SliceInfo.from_env(env)
    want = jax_sdk.SliceInfo.from_env(env)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.is_coordinator == want.is_coordinator


def test_the_wire_names_and_patches_equal_the_reference():
    names = [n for n in dir(keys) if n.isupper()]
    assert names and all(getattr(keys, n) == getattr(jax_keys, n)
                         for n in names)
    consts = [n for n in dir(notebook) if n.endswith("_ANNOTATION")]
    assert consts == [n for n in dir(jax_nb) if n.endswith("_ANNOTATION")]
    assert len(consts) == 34
    assert all(getattr(notebook, n) == getattr(jax_nb, n) for n in consts)
    for now in (0.0, 1.7e9, 1.7e9 + 0.25):
        assert objects.fmt_iso(now) == jax_objects.fmt_iso(now)
    for text in ("2026-10-17T12:00:00Z", "2026-10-17T12:00:00.125Z", "x", ""):
        assert objects.parse_iso(text) == jax_objects.parse_iso(text)
    assert protocol.ack_patch("/p", 7, 1.7e9, for_request="r") == \
        jax_protocol.ack_patch("/p", 7, 1.7e9, for_request="r")
    assert protocol.ack_patch("/p", 7, 1.7e9) == \
        jax_protocol.ack_patch("/p", 7, 1.7e9)
    assert protocol.commit_patch(1.7e9, for_request="r") == \
        jax_protocol.commit_patch(1.7e9, for_request="r")
    assert protocol.progress_patch(3, 9) == jax_protocol.progress_patch(3, 9)
    assert protocol.restore_tier_patch("") == \
        jax_protocol.restore_tier_patch("")
    drained = jax_protocol.request_drain_patch("cull", 100.0)
    for ann in ({}, drained, {**drained, **jax_protocol.ack_patch(
            "/p", 1, 101.0, for_request=drained[
                jax_nb.DRAIN_REQUESTED_ANNOTATION])},
                {**drained, jax_nb.CHECKPOINTED_FOR_ANNOTATION: "other"}):
        ann = {k: v for k, v in ann.items() if v is not None}
        assert protocol.drain_acked(ann) == jax_protocol.drain_acked(ann)


# ---- the guard, through both packages ------------------------------------------

_STAMPED = (notebook.CHECKPOINTING_AT_ANNOTATION,
            notebook.CHECKPOINTED_AT_ANNOTATION,
            notebook.CHECKPOINT_COMMITTED_AT_ANNOTATION)


class _Manager:
    """The manager surface the guard uses, recording its calls; with
    ``fabric`` it has ``save_async`` and commits when told."""

    def __init__(self, fabric: bool):
        self.directory = "/home/jovyan/ckpt"
        self.calls, self._uploads = [], []
        if fabric:
            self.save_async = self._save_async
            self.last_restore = {"step": 4, "tier": "staging",
                                 "seconds": 0.01, "fallback": False}

    def save(self, step, pytree, *, force=False):
        due = force or step % 5 == 0
        self.calls.append(("save", step, force, due))
        return due

    def wait(self):
        self.calls.append(("wait",))

    def _save_async(self, step, pytree, *, on_progress=None, on_commit=None):
        self.calls.append(("save_async", step))
        self._uploads.append((step, on_progress, on_commit))

    def commit(self):
        for step, on_progress, on_commit in self._uploads:
            on_progress(3, 3)
            on_commit(step, 0.01)
        self._uploads = []

    def close(self):
        self.calls.append(("close",))
        self.commit()


def _drive(mod, scenario) -> tuple:
    """Run one guard scenario through ``mod`` (either package's sdk): the
    patches it sent, timestamps replaced, and the manager's calls."""
    ann, patches, fail = {}, [], {"ack": 0, "commit": 0}

    def patcher(update):
        kind = ("commit" if notebook.CHECKPOINT_COMMITTED_AT_ANNOTATION
                in update and notebook.CHECKPOINTED_AT_ANNOTATION
                not in update else "ack"
                if notebook.CHECKPOINTED_AT_ANNOTATION in update else None)
        if kind and fail[kind]:
            fail[kind] -= 1
            raise OSError("apiserver flake")
        patches.append({k: ("<ts>" if k in _STAMPED and v else v)
                        for k, v in update.items()})
        for k, v in update.items():
            ann.pop(k, None) if v is None else ann.__setitem__(k, v)

    manager = _Manager(fabric=scenario != "maintenance_and_legacy_drain")
    watcher = mod.MaintenanceWatcher(fetch=lambda: dict(ann), interval=0.0)
    guard = mod.CheckpointGuard(manager, watcher, sync_every_steps=1,
                                patcher=patcher)
    drain = {k: v for k, v in jax_protocol.request_drain_patch(
        "preempt:idle", 100.0).items() if v is not None}
    if scenario == "fabric_drain":
        guard.step(1, {})
        ann.update(drain)
        guard.step(2, {})               # snapshot, ack before the upload
        manager.commit()                # commit mark after the upload
        guard.step(3, {})               # acked: no second save
        guard.close()
    elif scenario == "retried_ack_and_commit":
        ann.update(drain)
        fail.update(ack=1, commit=1)
        guard.step(2, {})               # snapshot; the ack patch fails
        guard.step(3, {})               # the ack again, no new snapshot
        manager.commit()                # the commit mark fails ...
        guard.close()                   # ... and close flushes it
    else:
        ann[notebook.MAINTENANCE_ANNOTATION] = "node-a"
        guard.step(1, {})               # forced save, then wait
        guard.step(2, {})               # same window: no second force
        ann.update(drain)
        guard.step(3, {})               # drain: save, wait, ack + commit
        del ann[notebook.MAINTENANCE_ANNOTATION]
        guard.step(5, {})               # the manager's own schedule
    return patches, manager.calls, guard.drained


@pytest.mark.parametrize("scenario", ["fabric_drain",
                                      "retried_ack_and_commit",
                                      "maintenance_and_legacy_drain"])
def test_the_guard_sends_the_reference_patches(scenario):
    got, want = _drive(sdk, scenario), _drive(jax_sdk, scenario)
    assert got == want
    patches, calls, drained = got
    assert drained
    acks = [i for i, p in enumerate(patches)
            if notebook.CHECKPOINTED_AT_ANNOTATION in p]
    commits = [i for i, p in enumerate(patches)
               if notebook.CHECKPOINT_COMMITTED_AT_ANNOTATION in p]
    assert acks and commits and acks[0] <= commits[0]
    if scenario != "maintenance_and_legacy_drain":
        assert acks[0] < commits[0]     # the ack goes out before the commit
        assert [c for c in calls if c[0] == "save_async"] == \
            [("save_async", 2)]


def _world_guard(rank: int) -> dict:
    """A world of 2: rank 0's watcher sees a drain from step 3, rank 1's
    sees nothing; both must force the save at step 3."""
    ann = {}
    manager = _Manager(fabric=False)
    patches = []
    guard = sdk.CheckpointGuard(
        manager, sdk.MaintenanceWatcher(fetch=lambda: dict(ann),
                                        interval=0.0),
        sync_every_steps=1, patcher=patches.append)
    for step in range(1, 7):
        if rank == 0 and step == 3:
            ann.update({k: v for k, v in jax_protocol.request_drain_patch(
                "cull", 100.0).items() if v is not None})
        guard.step(step, {})
    forced = [c[1] for c in manager.calls if c[0] == "save" and c[2]]
    return {"forced": forced, "drained": guard.drained,
            "acks": sum(notebook.CHECKPOINTED_AT_ANNOTATION in p
                        for p in patches)}


def test_rank_0s_drain_signal_makes_both_ranks_save_at_the_same_step():
    ranks = run_world(_world_guard, 2, timeout=120)
    assert [r["forced"] for r in ranks] == [[3], [3]]
    assert all(r["drained"] for r in ranks)
    # One writer of the ack (every rank stamps the best-effort
    # checkpointing-at mark, as in the reference).
    assert [r["acks"] for r in ranks] == [1, 0]


def test_the_guard_over_the_real_fabric_acks_then_commits(tmp_path):
    ann, patches = {}, []

    def patcher(update):
        patches.append(dict(update))
        for k, v in update.items():
            ann.pop(k, None) if v is None else ann.__setitem__(k, v)

    fab = CheckpointFabric(str(tmp_path / "remote"),
                           staging_dir=str(tmp_path / "staging"),
                           chunk_bytes=64, remote_op_delay=0.01,
                           registry=Registry())
    tree = {"w": torch.arange(32.0), "h": torch.ones(8, dtype=torch.bfloat16)}
    with sdk.CheckpointGuard(fab, sdk.MaintenanceWatcher(
            fetch=lambda: dict(ann), interval=0.0), sync_every_steps=1,
            patcher=patcher) as guard:
        ann.update({k: v for k, v in jax_protocol.request_drain_patch(
            "suspend", 100.0).items() if v is not None})
        assert guard.step(2, tree) is True
        tree["w"].add_(1.0)              # the next step, after the ack
    assert fab.latest_step() == 2
    back = fab.restore()
    assert torch.equal(back["w"], torch.arange(32.0))
    assert back["h"].dtype == torch.bfloat16
    assert fab.remote.orphaned_tmp_files() == []
    assert notebook.CHECKPOINT_COMMITTED_AT_ANNOTATION in ann
    order = [k for p in patches for k in p
             if k in (notebook.CHECKPOINTED_AT_ANNOTATION,
                      notebook.CHECKPOINT_COMMITTED_AT_ANNOTATION)]
    assert order == [notebook.CHECKPOINTED_AT_ANNOTATION,
                     notebook.CHECKPOINT_COMMITTED_AT_ANNOTATION]


# ---- distributed bootstrap, profiler, the copied helpers -------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_child(rank: int, port: int, out) -> None:
    torch.set_num_threads(1)
    env = {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
           "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(rank)}
    first = sdk.initialize_distributed(env, device="cpu")
    second = sdk.initialize_distributed(env, device="cpu")
    total = torch.tensor([rank + 1.0])
    dist.all_reduce(total)
    out.put((rank, first, second, float(total), dist.get_world_size(),
             dist.get_backend()))
    dist.destroy_process_group()


def test_initialize_distributed_forms_a_gloo_world_from_the_env():
    # Spawned by hand: run_world's processes join a group of their own
    # before the function runs, and this one must form it from the env.
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_init_child, args=(rank, port, out))
             for rank in range(2)]
    for proc in procs:
        proc.start()
    try:
        got = sorted(out.get(timeout=120) for _ in procs)
    finally:
        for proc in procs:
            proc.join(30)
            if proc.is_alive():
                proc.kill()
    assert got == [(0, True, True, 3.0, 2, "gloo"),
                   (1, True, True, 3.0, 2, "gloo")]
    assert all(proc.exitcode == 0 for proc in procs)


def test_initialize_distributed_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sdk.initialize_distributed({})
    assert sdk.initialize_distributed({}, device="cpu") is False
    assert sdk.initialize_distributed({"JAX_NUM_PROCESSES": "1"},
                                      device="cpu") is False
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sdk.trace("/nonexistent")


def test_trace_and_capture_profile_write_under_the_logdir(tmp_path):
    with sdk.trace(str(tmp_path / "a"), device="cpu"):
        torch.ones(64).cumsum(0).sum()
    env = {sdk.TELEMETRY_LOGDIR_ENV: str(tmp_path / "b")}
    with sdk.capture_profile(environ=env, device="cpu"):
        torch.ones(8).sum()
    for sub in ("a", "b"):
        names = os.listdir(tmp_path / sub)
        assert any(n.endswith(".pt.trace.json") for n in names), names
    assert sdk.DEFAULT_TRACE_LOGDIR == jax_sdk.DEFAULT_TRACE_LOGDIR
    # The capture button's server: the reference's signature (its one
    # parameter, default the same port) and the port's keyword-only device.
    assert "start_profiler_server" in sdk.__all__
    assert sdk.PROFILER_PORT == jax_sdk.PROFILER_PORT == 9999
    got = inspect.signature(sdk.start_profiler_server).parameters
    want = inspect.signature(jax_sdk.start_profiler_server).parameters
    assert list(got) == [*want, "device"]
    assert all(got[name].kind == want[name].kind
               and got[name].default == want[name].default for name in want)
    assert got["device"].kind == inspect.Parameter.KEYWORD_ONLY
    assert got["device"].default is None


def test_trace_on_the_card_warms_cupti_up_before_its_window(monkeypatch,
                                                          tmp_path):
    """On the card, ``sdk.trace``'s session runs the warm-up once, after
    ``prepare_trace`` enabled the activities and before ``start_trace``
    opened the window, so the warm-up's own work is not in the trace (the
    card's session driven here with the host's activities alone)."""
    from torch.profiler import ProfilerActivity, tensorboard_trace_handler

    card = sdk.trace(str(tmp_path / "card"), device="cuda")
    assert isinstance(card, sdk._WarmedProfile)
    assert card.card == torch.device("cuda")
    assert card.activities == {ProfilerActivity.CPU, ProfilerActivity.CUDA}
    assert not isinstance(sdk.trace(str(tmp_path), device="cpu"),
                          sdk._WarmedProfile)
    seen = []

    def warm_up(device):
        seen.append((device, torch._C._autograd._profiler_enabled()))
        torch.ones(8).cumprod(0)

    monkeypatch.setattr(sdk, "_warm_up_cupti", warm_up)
    with sdk._WarmedProfile(torch.device("cpu"),
                            activities=[ProfilerActivity.CPU],
                            on_trace_ready=tensorboard_trace_handler(
                                str(tmp_path / "cpu"))):
        assert seen == [(torch.device("cpu"), False)]
        torch.ones(64).cumsum(0)
    assert seen == [(torch.device("cpu"), False)]
    [name] = os.listdir(tmp_path / "cpu")
    with open(tmp_path / "cpu" / name) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::cumsum" in names and "aten::cumprod" not in names


def test_suspend_resume_and_warm_idle_match_the_reference():
    got, want = [], []
    sdk.suspend(patcher=got.append)
    jax_sdk.suspend(patcher=want.append)
    sdk.resume(patcher=got.append)
    jax_sdk.resume(patcher=want.append)
    assert [sorted(p) for p in got] == [sorted(p) for p in want]
    assert got[-1] == want[-1] == {notebook.SUSPEND_ANNOTATION: None}
    polls = iter([None, "", "ns/nb/nonce"])
    claim = sdk.warm_idle(fetch_claim=lambda: next(polls),
                          init_devices=False, _sleep=lambda _s: None)
    assert claim == "ns/nb/nonce"
    assert sdk.warm_idle(fetch_claim=lambda: None, init_devices=False,
                         max_wait=0.0) is None


def test_warm_idle_without_a_card_stays_warm(monkeypatch, tmp_path):
    """A pod that cannot attach a card (or build the kernels) still parks
    and returns its claim, as the reference does without devices."""
    monkeypatch.setattr(torch.cuda, "init", lambda: (_ for _ in ()).throw(
        RuntimeError("no card")))
    claim_file = tmp_path / "annotations"
    claim_file.write_text(f'{keys.TPU_WARM_CLAIM}="ns/nb/1"\n')
    env = {sdk.WARM_CLAIM_FILE_ENV: str(claim_file)}
    assert sdk.warm_idle(environ=env, _sleep=lambda _s: None) == "ns/nb/1"


def test_watcher_and_publisher_behave_as_the_reference():
    ann = {}
    got = sdk.MaintenanceWatcher(fetch=lambda: dict(ann), interval=0.0)
    want = jax_sdk.MaintenanceWatcher(fetch=lambda: dict(ann), interval=0.0)
    for value in (None, "node-a", None):
        if value:
            ann[notebook.MAINTENANCE_ANNOTATION] = value
        else:
            ann.pop(notebook.MAINTENANCE_ANNOTATION, None)
        assert got.check() == want.check() == value
        assert got.annotations() == want.annotations()
    with pytest.raises(ValueError, match="NB_PREFIX"):
        sdk.MaintenanceWatcher(environ={})
    with pytest.raises(ValueError, match="NB_PREFIX"):
        sdk.telemetry_publisher(environ={})
    bodies = []
    pub = sdk.telemetry_publisher(patcher=bodies.append, environ={})
    assert isinstance(pub, TelemetryPublisher)
    np.testing.assert_equal(pub.seq, 0)
