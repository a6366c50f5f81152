"""The port's checkpoint stack (``kubeflow_tpu_torch.checkpoint`` and the
trainer's checkpoint tree) against the JAX package's.

The same numpy train state goes through both fabrics and must give the
same manifest, chunk for chunk; a step the JAX package saved restores
bitwise in the port and resumes along the JAX trajectory; a step saved in
the port, through the fabric or through the DCP manager, resumes bitwise
equal to a straight run. Small config (test_torch_trainer.py's), CPU.
"""

import os
from functools import partial

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp

from kubeflow_tpu.checkpoint import CheckpointFabric as JaxFabric
from kubeflow_tpu.checkpoint.store import decode_manifest
from kubeflow_tpu.models import burnin as jax_burnin
from kubeflow_tpu.models import trainer as jax_trainer
from kubeflow_tpu.runtime.metrics import Registry as JaxRegistry
from kubeflow_tpu_torch.checkpoint import (CheckpointFabric,
                                           CheckpointIntegrityError,
                                           CheckpointManager, LeafSpec)
from kubeflow_tpu_torch.checkpoint.fabric import _flatten
from kubeflow_tpu_torch.models import burnin, params_from_jax, trainer
from kubeflow_tpu_torch.parallel.launch import run_world
from kubeflow_tpu_torch.parallel.mesh import MeshPlan, make_mesh, shard
from kubeflow_tpu_torch.runtime.metrics import Registry
from kubeflow_tpu_torch.utils.checkpoint import \
    CheckpointManager as ShimManager

from test_torch_trainer import CFG, JCFG, KW, TRAIN, TRAJECTORY_TOL

torch.set_num_threads(1)

OPTIMIZERS = ["adamw", "sgd"]


def _batches(n, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, KW["vocab"], (batch, KW["seq_len"]))
            .astype(np.int32) for _ in range(n)]


def _jax_params():
    return jax.device_get(jax_burnin.init_params(jax.random.key(0), JCFG))


def _jax_run(optimizer, steps, save_at=None):
    """The JAX package's state after ``steps`` steps (numpy), and the
    state at ``save_at`` (numpy) when asked."""
    tx = jax_trainer.make_optimizer(
        jax_trainer.TrainerConfig(**TRAIN, optimizer=optimizer))
    state = jax_trainer.init_state(_jax_params(), tx)
    step = jax.jit(jax_trainer.make_train_step(
        partial(jax_burnin.loss_fn, cfg=JCFG), tx))
    mid = None
    for i, batch in enumerate(_batches(steps)):
        state, _ = step(state, jnp.asarray(batch))
        if i + 1 == save_at:
            mid = jax.device_get(state)
    return jax.device_get(state), mid


def _optimizer(optimizer):
    return trainer.make_optimizer(
        trainer.TrainerConfig(**TRAIN, optimizer=optimizer))


def _params():
    return params_from_jax(_jax_params(), CFG, device="cpu")


def _port_tree(jstate, optimizer) -> dict:
    """A JAX state (numpy) in the port's checkpoint layout, by hand: the
    params and moments converted into the port's tree order."""
    def tensors(tree):
        return params_from_jax(tree, CFG, device="cpu")

    def count(x):
        return torch.tensor(int(x), dtype=torch.int32)

    if optimizer == "sgd":
        inner = ((), ())
    else:
        adam, _, schedule = jstate["opt_state"][1]
        inner = ((count(adam.count), tensors(adam.mu), tensors(adam.nu)),
                 (), (count(schedule.count),))
    return {"params": tensors(jstate["params"]), "opt_state": ((), inner),
            "step": count(jstate["step"])}


def _manifest(directory, step) -> dict:
    with open(os.path.join(directory, "manifests",
                           f"manifest-{step}.json"), "rb") as fh:
        return decode_manifest(fh.read())


def _leaves(tree) -> list:
    """(path, numpy) pairs in the fabric's (sorted-key) order."""
    return [(path, x.numpy() if torch.is_tensor(x) else np.asarray(x))
            for path, x in _flatten(tree)[0]]


def _bitwise(a, b) -> bool:
    return all(torch.equal(x, y) and x.dtype == y.dtype
               for (_, x), (_, y) in zip(_flatten(a)[0], _flatten(b)[0]))


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_both_fabrics_write_the_same_manifest(tmp_path, optimizer):
    """The same numbers (a JAX state after 2 steps, and a bf16 leaf) saved
    by the JAX fabric from numpy and by the port's from tensors: the same
    skeleton, keys, dtypes, shapes and chunk hashes."""
    jstate, _ = _jax_run(optimizer, steps=2)
    bits = np.random.default_rng(4).standard_normal((3, 5)).astype(
        ml_dtypes.bfloat16)
    with JaxFabric(str(tmp_path / "jax"), chunk_bytes=256,
                   registry=JaxRegistry()) as fab:
        assert fab.save_async(2, {**jstate, "extra": bits}).result(30)
    state = trainer.load_state(_port_tree(jstate, optimizer),
                               _optimizer(optimizer))
    extra = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    with CheckpointFabric(str(tmp_path / "port"), chunk_bytes=256,
                          registry=Registry()) as fab:
        assert fab.save_async(
            2, {**trainer.checkpoint_tree(state), "extra": extra}).result(30)
    want, got = _manifest(tmp_path / "jax", 2), _manifest(tmp_path / "port", 2)
    assert got["tree"] == want["tree"]
    assert got["leaves"] == want["leaves"]
    assert got == want
    dtypes = {leaf["key"]: leaf["dtype"] for leaf in got["leaves"]}
    assert dtypes["/extra"] == "bfloat16" and dtypes["/step"] == "int32"
    if optimizer == "adamw":
        assert dtypes["/opt_state[1][0][0]"] == "int32"
        assert dtypes["/opt_state[1][2][0]"] == "int32"
        assert dtypes["/opt_state[1][0][1]/embed"] == "float32"


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_a_jax_checkpoint_restores_bitwise_and_resumes_in_the_port(
        tmp_path, optimizer):
    """A step the JAX package saved after k steps restores bitwise in the
    port (a bf16 leaf too) and, resumed for n - k steps, stays within the
    trajectory test's bound of the JAX package's n-step run."""
    k, n = 3, 6
    jfinal, jmid = _jax_run(optimizer, steps=n, save_at=k)
    bits = np.arange(12, dtype=np.float32).reshape(3, 4).astype(
        ml_dtypes.bfloat16)
    with JaxFabric(str(tmp_path), registry=JaxRegistry()) as fab:
        assert fab.save_async(k, {**jmid, "extra": bits}).result(30)
    tx = _optimizer(optimizer)
    abstract = {**trainer.abstract_state(_params(), tx),
                "extra": LeafSpec((3, 4), torch.bfloat16,
                                  torch.device("cpu"))}
    with CheckpointFabric(str(tmp_path), registry=Registry()) as fab:
        tree = fab.restore(abstract=abstract)
    assert fab.last_restore["step"] == k
    extra = tree.pop("extra")
    assert extra.dtype == torch.bfloat16
    np.testing.assert_array_equal(extra.view(torch.int16).numpy(),
                                  bits.view(np.int16))
    got, want = _leaves(tree), _leaves(jmid)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)
    state = trainer.load_state(tree, tx)
    assert state["step"] == k
    step = trainer.make_train_step(partial(burnin.loss_fn, cfg=CFG), tx)
    batches = [torch.from_numpy(b).long() for b in _batches(n)]
    state = trainer.fit(state, iter(batches), steps=n, step_fn=step)
    ours = _leaves({"params": state["params"]})
    for (path, g), (_, w) in zip(ours, _leaves({"params":
                                                jfinal["params"]})):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=TRAJECTORY_TOL[optimizer],
                                   err_msg=path)


def _checkpointer(arm, tmp_path):
    if arm == "fabric":
        return CheckpointFabric(str(tmp_path / "remote"),
                                staging_dir=str(tmp_path / "staging"),
                                chunk_bytes=1024, registry=Registry())
    return CheckpointManager(str(tmp_path / "dcp"))


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("arm", ["fabric", "manager"])
def test_resume_at_k_through_a_checkpointer_is_bitwise_a_straight_run(
        tmp_path, arm, optimizer):
    """fit saves at 2 and 4; a fresh state restored at 2 through
    abstract_state and load_state, run to 4, equals the straight run bit
    for bit: params, moments, counts and the scheduled lr."""
    tx = _optimizer(optimizer)
    step = trainer.make_train_step(partial(burnin.loss_fn, cfg=CFG), tx)
    batches = [torch.from_numpy(b).long() for b in _batches(4)]
    ckpt = _checkpointer(arm, tmp_path)
    try:
        straight = trainer.fit(trainer.init_state(_params(), tx),
                               iter(batches), steps=4, step_fn=step,
                               checkpoints=ckpt, save_every=2)
        assert ckpt.all_steps() == [2, 4] and ckpt.latest_step() == 4
        tree = ckpt.restore(2, abstract=trainer.abstract_state(_params(), tx))
    finally:
        ckpt.close()
    resumed = trainer.load_state(tree, tx)
    assert resumed["step"] == 2
    resumed = trainer.fit(resumed, iter(batches), steps=4, step_fn=step)
    assert resumed["step"] == straight["step"] == 4
    assert _bitwise(trainer.checkpoint_tree(resumed),
                    trainer.checkpoint_tree(straight))
    assert list(resumed["params"]) == list(straight["params"])
    if optimizer == "adamw":
        lr = [g["lr"] for g in resumed["opt_state"]["optimizer"].param_groups]
        assert lr == [g["lr"] for g in
                      straight["opt_state"]["optimizer"].param_groups]
        assert resumed["opt_state"]["schedule"].last_epoch == 4


def test_load_state_resumes_the_schedule_not_at_lr_0():
    """A state restored at step 5 runs at the schedule's lr of count 5,
    not at the warmup's first value (0): the groups' lr is restored."""
    tx = _optimizer("adamw")
    state = trainer.init_state(_params(), tx)
    tree = trainer.checkpoint_tree(state)
    inner = tree["opt_state"][1]
    tree["opt_state"] = ((), ((torch.tensor(5, dtype=torch.int32),
                                *inner[0][1:]), (),
                               (torch.tensor(5, dtype=torch.int32),)))
    resumed = trainer.load_state(tree, tx)
    factor = trainer.warmup_cosine(tx.cfg)(5)
    groups = resumed["opt_state"]["optimizer"].param_groups
    assert groups[0]["lr"] == TRAIN["lr"] * factor > 0
    opt = resumed["opt_state"]["optimizer"]
    first = opt.state[burnin.map_params(lambda p: p, resumed["params"])
                      ["embed"]]
    assert float(first["step"]) == 5.0 and first["step"].device.type == "cpu"


def test_checkpoint_tree_before_the_first_step_is_optax_init(tmp_path):
    """Before AdamW has made its lazy state, the tree holds zero moments
    and zero counts, as optax's init does."""
    tx = _optimizer("adamw")
    jtx = jax_trainer.make_optimizer(jax_trainer.TrainerConfig(**TRAIN))
    jstate = jax.device_get(jax_trainer.init_state(_jax_params(), jtx))
    tree = trainer.checkpoint_tree(trainer.init_state(_params(), tx))
    got, want = _leaves(tree), _leaves(jstate)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=path)


# ---- the fabric's faults on the port's leaves ----------------------------------


class _Faults:
    """Storage faults that fire for their first N probes."""

    def __init__(self, *, crash=0):
        self.crash = crash

    def should_crash_upload(self):
        if self.crash > 0:
            self.crash -= 1
            return True
        return False


def _tree(step: int) -> dict:
    return {"step": torch.tensor(step, dtype=torch.int32),
            "w": torch.arange(64, dtype=torch.float32) + step,
            "h": (torch.arange(16, dtype=torch.float32) / 7 + step).to(
                torch.bfloat16)}


def _small_fabric(tmp_path, **kw):
    kw.setdefault("chunk_bytes", 64)
    return CheckpointFabric(str(tmp_path / "remote"), registry=Registry(),
                            full_interval=1, **kw)


def test_a_torn_manifest_falls_back_to_the_previous_step(tmp_path):
    with _small_fabric(tmp_path) as fab:
        fab.save_async(1, _tree(1)).result(10)
        fab.save_async(2, _tree(2)).result(10)
        path = fab.remote._manifest_path(2)
        raw = open(path, "rb").read()
        with open(path, "wb") as fh:
            fh.write(raw[: len(raw) // 2])
        tree = fab.restore()
    assert fab.last_restore["step"] == 1 and fab.last_restore["fallback"]
    assert _bitwise(tree, _tree(1))


def test_a_corrupt_chunk_falls_back_to_the_previous_step(tmp_path):
    with _small_fabric(tmp_path) as fab:
        fab.save_async(1, _tree(1)).result(10)
        before = set(os.listdir(fab.remote._chunk_dir))
        fab.save_async(2, _tree(2)).result(10)
        for digest in set(os.listdir(fab.remote._chunk_dir)) - before:
            with open(fab.remote._chunk_path(digest), "r+b") as fh:
                fh.write(b"\xff")
        tree = fab.restore()
    assert fab.last_restore["step"] == 1 and fab.last_restore["fallback"]
    assert _bitwise(tree, _tree(1))
    for digest in before:                    # and with nothing intact left
        with open(fab.remote._chunk_path(digest), "r+b") as fh:
            fh.write(b"\xff")
    with _small_fabric(tmp_path) as fab:
        with pytest.raises(CheckpointIntegrityError):
            fab.restore()


def test_a_crash_mid_upload_never_commits(tmp_path):
    with _small_fabric(tmp_path, faults=_Faults(crash=1),
                       staging_dir=str(tmp_path / "staging")) as fab:
        first = fab.save_async(1, _tree(1))
        assert first.result(10) is False and first.error is not None
        assert fab.latest_step() is None
        with pytest.raises(FileNotFoundError):
            fab.restore()
        assert fab.save_async(2, _tree(2)).result(10) is True
        tree = fab.restore()
    assert fab.latest_step() == 2 and _bitwise(tree, _tree(2))
    assert fab.remote.orphaned_tmp_files() == []


def test_the_snapshot_is_a_copy_taken_before_save_async_returns(tmp_path):
    """The train step updates its tensors in place: the snapshot must not
    see an update made after save_async returned."""
    tree = _tree(3)
    with _small_fabric(tmp_path) as fab:
        handle = fab.save_async(3, tree)
        tree["w"].add_(100.0)
        tree["h"].add_(100.0)
        handle.result(10)
        restored = fab.restore()
    assert _bitwise(restored, _tree(3))


# ---- placement, refusals and the manager's surface ------------------------------


def test_a_cuda_abstract_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    abstract = {"step": LeafSpec((), torch.int32, torch.device("cuda")),
                "w": LeafSpec((64,), torch.float32, torch.device("cuda")),
                "h": LeafSpec((16,), torch.bfloat16, torch.device("cuda"))}
    with _small_fabric(tmp_path) as fab:
        fab.save_async(1, _tree(1)).result(10)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fab.restore(abstract=abstract)
    with CheckpointManager(str(tmp_path / "dcp")) as mgr:
        mgr.save(1, _tree(1))
        mgr.wait()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mgr.restore(abstract=abstract)


def test_an_abstract_of_another_shape_raises(tmp_path):
    abstract = {"step": LeafSpec((), torch.int32, torch.device("cpu")),
                "w": LeafSpec((65,), torch.float32, torch.device("cpu")),
                "h": LeafSpec((16,), torch.bfloat16, torch.device("cpu"))}
    with _small_fabric(tmp_path) as fab:
        fab.save_async(1, _tree(1)).result(10)
        with pytest.raises(ValueError, match="shape"):
            fab.restore(abstract=abstract)


def test_the_manager_lists_whole_steps_keeps_and_names_the_available(
        tmp_path):
    with CheckpointManager(str(tmp_path), keep=2,
                           save_interval_steps=2) as mgr:
        assert mgr.save(1, _tree(1)) is False          # off the interval
        for step in (2, 4, 6):
            assert mgr.save(step, _tree(step)) is True
        assert mgr.save(6, _tree(6), force=True) is False   # saved already
        mgr.wait()
        assert mgr.all_steps() == [4, 6] and mgr.latest_step() == 6
        os.makedirs(tmp_path / ".tmp-8")                # half written
        os.makedirs(tmp_path / "10")                    # no tree: not a step
        assert mgr.all_steps() == [4, 6]
        with pytest.raises(FileNotFoundError, match=r"available steps: \[4, 6\]"):
            mgr.restore(5)
        tree = mgr.restore()
    assert _bitwise(tree, _tree(6))
    assert tree["h"].dtype == torch.bfloat16 and tree["w"].device.type == "cpu"
    assert ShimManager is CheckpointManager
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        CheckpointManager(str(tmp_path / "empty")).restore()


# ---- the DCP manager over a world of 4 ------------------------------------------


def _world_dcp(rank: int, directory: str, jparams) -> dict:
    mesh = make_mesh(MeshPlan(2, 2), device_type="cpu")
    tx = _optimizer("adamw")
    rules = burnin.param_sharding_rules(CFG)
    params = params_from_jax(jparams, CFG, device="cpu")
    state_rules = trainer.state_sharding_rules(rules, params, tx)
    state = trainer.shard_state(trainer.init_state(params, tx), mesh,
                                state_rules)
    step = trainer.make_train_step(
        partial(burnin.loss_fn, cfg=CFG, mesh=mesh), tx, mesh=mesh,
        rules=state_rules)
    tokens = torch.from_numpy(_batches(1, batch=4)[0]).long()
    state, _ = step(state, tokens[2 * mesh.get_local_rank("data"):][:2])
    abstract = trainer.abstract_state(params, tx, rules=rules, mesh=mesh)
    saved = trainer.checkpoint_tree(state)
    with CheckpointManager(os.path.join(directory, "sharded"),
                           abstract=abstract) as mgr:
        mgr.save(1, saved)
        mgr.wait()
        back = mgr.restore(1)
        try:
            mgr.restore(1, abstract=trainer.abstract_state(params, tx))
            refused = False
        except ValueError:
            refused = True
    keys = sorted(dcp.FileSystemReader(os.path.join(
        directory, "sharded", "1")).read_metadata().state_dict_metadata)
    # A whole checkpoint (every process saves the same global tree) onto
    # the sharded abstract: each process gets its shard of every leaf.
    whole = trainer.checkpoint_tree(trainer.init_state(
        params_from_jax(jparams, CFG, device="cpu"), _optimizer("adamw")))
    with CheckpointManager(os.path.join(directory, "whole")) as mgr:
        mgr.save(0, whole)
        mgr.wait()
        cut = mgr.restore(0, abstract=abstract)
    specs = dict(_flatten(abstract)[0])
    cut_ok = all(
        torch.equal(got, shard(want, specs[path].rule, mesh))
        for (path, got), (_, want) in zip(_flatten(cut)[0],
                                          _flatten(whole)[0]))
    return {"bitwise": _bitwise(back, saved), "refused": refused,
            "keys": keys, "cut_ok": cut_ok,
            "qkv_shape": list(back["params"]["layers"][0]["qkv"].shape)}


def test_the_dcp_manager_saves_and_restores_each_ranks_shard_at_world_4(
        tmp_path):
    """2 x 2 over gloo: every rank's shard of a trained sharded state
    round-trips bitwise; cut leaves are keyed by their model coordinate
    (DCP would otherwise keep one rank's copy of a shared key); a sharded
    step refuses an unsharded abstract; a whole checkpoint restored onto
    the sharded abstract gives each rank ``shard(leaf)``."""
    ranks = run_world(_world_dcp, 4, str(tmp_path), _jax_params(),
                      timeout=180)
    for r in ranks:
        assert r["bitwise"] and r["refused"] and r["cut_ok"]
        assert r["qkv_shape"] == [KW["d_model"], 3 * KW["d_model"] // 2]
    keys = ranks[0]["keys"]
    assert "/params/layers[0]/qkv#model=0" in keys
    assert "/params/layers[0]/qkv#model=1" in keys
    assert "/opt_state[1][0][1]/layers[0]/ff2#model=1" in keys
    assert "/params/embed" in keys and "/step" in keys
