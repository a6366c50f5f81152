"""The port's input pipeline (``kubeflow_tpu_torch.data``) against the JAX
package's (``kubeflow_tpu.data``).

Loader parity: the same source, seed, process split, skip, state_dict and
prefetch rewind cases give bitwise the same batches in both packages.
``global_batches``: each process's block on its device, data peers
disjoint and model peers equal at world 4 (2 x 2), a loader placed by
rank instead of by ``mesh_place`` refused.
"""

import time
from functools import partial

import numpy as np
import pytest
import torch

from kubeflow_tpu import data as jax_data
from kubeflow_tpu_torch import data
from kubeflow_tpu_torch.checkpoint import CheckpointFabric
from kubeflow_tpu_torch.checkpoint.fabric import _flatten
from kubeflow_tpu_torch.models import burnin, trainer
from kubeflow_tpu_torch.parallel.launch import run_world
from kubeflow_tpu_torch.parallel.mesh import MeshPlan, make_mesh
from kubeflow_tpu_torch.runtime.metrics import Registry

torch.set_num_threads(1)


def make_source(mod, n=64, width=3):
    x = np.arange(n * width, dtype=np.float32).reshape(n, width)
    y = np.arange(n, dtype=np.int32)
    return mod.ArraySource(x, y)


def loader(mod, seed, **kw):
    kw.setdefault("process_id", 0)
    kw.setdefault("num_processes", 1)
    return mod.ShardedLoader(make_source(mod), batch_size=8, seed=seed, **kw)


def take(it, k):
    it = iter(it)
    return [next(it) for _ in range(k)]


def ys(batches):
    return [y.tolist() for _, y in batches]


# Each scenario runs against one package's module and returns the batches
# it saw; the two packages must agree bitwise, and each scenario asserts
# the semantics the JAX package's tests pin.

def straight(mod):
    out = []
    for seed, pid, nproc, shuffle in ((0, 0, 1, True), (5, 1, 2, True),
                                      (9, 2, 4, True), (3, 0, 2, False)):
        ld = loader(mod, seed, process_id=pid, num_processes=nproc,
                    shuffle=shuffle)
        out += take(ld, 3 * ld.batches_per_process + 1)   # crosses epochs
    return out


def skip(mod):
    ld = loader(mod, 13)
    ld.skip(11)
    got = take(ld, 9)
    assert ys(got) == ys(take(loader(mod, 13), 20))[11:]
    return got


def state_dict(mod):
    ld = loader(mod, 1)
    take(ld, 5)
    snap = ld.state_dict()
    want = take(ld, 4)
    again = loader(mod, 1)
    again.load_state_dict(snap)
    got = take(again, 4)
    assert ys(got) == ys(want) and snap == {"epoch": 0, "batch_in_epoch": 5}
    return got


def rewind(mod):
    ld = loader(mod, 3)
    take(ld, 11)
    ld.rewind(5)
    assert ld.state_dict() == {"epoch": 0, "batch_in_epoch": 6}
    got = take(ld, 3)
    ld.rewind(100)
    assert ld.state_dict() == {"epoch": 0, "batch_in_epoch": 0}
    return got


def prefetch_close_rewinds(mod):
    expect = ys(take(loader(mod, 7), 10))
    ld = loader(mod, 7)
    pf = mod.prefetch(ld, depth=3)
    got = [next(pf) for _ in range(4)]
    pf.close()
    pf = mod.prefetch(ld, depth=3)
    got += [next(pf) for _ in range(6)]
    pf.close()
    assert ys(got) == expect, "read-ahead batches were dropped"
    return got


def prefetch_rebind(mod):
    expect = ys(take(loader(mod, 9), 12))
    ld = loader(mod, 9)
    pf = mod.prefetch(ld, depth=3)
    got = [next(pf) for _ in range(4)]
    pf = mod.prefetch(ld, depth=3)     # rebind; the old one never closed
    got += [next(pf) for _ in range(8)]
    pf.close()
    assert ys(got) == expect, "handoff lost or duplicated batches"
    return got


def skip_between_prefetchers(mod):
    expect = ys(take(loader(mod, 17), 12))
    ld = loader(mod, 17)
    pf = mod.prefetch(ld, depth=3)
    [next(pf) for _ in range(6)]
    ld.skip(2)                         # resume from a checkpoint at step 2
    pf = mod.prefetch(ld, depth=3)
    got = [next(pf) for _ in range(4)]
    pf.close()
    assert ys(got) == expect[2:6], "deferred rewind clobbered the skip"
    return got


def prefetch_iterator_does_not_rewind(mod):
    ld = loader(mod, 7)
    pf = mod.prefetch(iter(ld), depth=3)
    got = [next(pf)]
    deadline = time.time() + 5
    while time.time() < deadline and ld._linear() < 3:
        time.sleep(0.01)               # let the producer read ahead
    ahead = ld._linear()
    assert ahead >= 3
    pf.close()
    assert ld._linear() == ahead       # ran ahead and stayed there
    return got


def transform_failure_retried(mod):
    calls = [0]

    def flaky(batch):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("augmentation bug")
        return batch

    expect = ys(take(loader(mod, 37), 4))
    ld = loader(mod, 37, transform=flaky)
    pf = mod.prefetch(ld, depth=2)
    got = [next(pf)]
    with pytest.raises(RuntimeError, match="augmentation bug"):
        while True:
            got.append(next(pf))
    pf = mod.prefetch(ld, depth=2)     # re-run the cell
    got.append(next(pf))
    pf.close()
    assert ys(got) == expect[:3], "failed batch was skipped, not retried"
    return got


def direct_failure_retried(mod):
    calls = [0]

    def flaky(batch):
        calls[0] += 1
        if calls[0] == 2:
            raise OSError("transient read error")
        return batch

    expect = ys(take(loader(mod, 41), 3))
    ld = loader(mod, 41, transform=flaky)
    it = iter(ld)
    got = [next(it)]
    with pytest.raises(OSError):
        next(it)
    assert ld.state_dict() == {"epoch": 0, "batch_in_epoch": 1}
    got += take(ld, 2)
    assert ys(got) == expect, "failed batch was consumed, not retried"
    return got


SCENARIOS = [straight, skip, state_dict, rewind, prefetch_close_rewinds,
             prefetch_rebind, skip_between_prefetchers,
             prefetch_iterator_does_not_rewind, transform_failure_retried,
             direct_failure_retried]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_loader_matches_the_jax_loader(scenario):
    want, got = scenario(jax_data), scenario(data)
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_the_default_place_is_the_port_slice_info(monkeypatch):
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    ld = data.ShardedLoader(make_source(data), batch_size=8)
    ref = jax_data.ShardedLoader(make_source(jax_data), batch_size=8)
    assert (ld.process_id, ld.num_processes) == (1, 2)
    assert ys(take(ld, 5)) == ys(take(ref, 5))


def test_global_batches_in_a_world_of_one_copies_the_whole_batch():
    batches = take(loader(data, 2), 3)
    placed = list(data.global_batches(iter(batches), device="cpu"))
    for (x, y), (px, py) in zip(batches, placed):
        assert torch.is_tensor(px) and px.device.type == "cpu"
        np.testing.assert_array_equal(px.numpy(), x)
        np.testing.assert_array_equal(py.numpy(), y)
        assert px.data_ptr() != torch.from_numpy(x).data_ptr()
    assert data.mesh_place(None) == (0, 1)


def test_global_batches_without_a_card_raises_at_the_call(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.global_batches(iter([]))


def _world_batches(rank: int, by_rank: bool) -> dict:
    mesh = make_mesh(MeshPlan(2, 2), device_type="cpu")
    pid, n = (rank, 4) if by_rank else data.mesh_place(mesh)
    ld = data.ShardedLoader(make_source(data), batch_size=4, seed=5,
                            process_id=pid, num_processes=n)
    try:
        stream = data.global_batches(data.prefetch(ld), mesh, ("data",),
                                     device="cpu")
        blocks = [y.clone() for _, y in take(stream, 3)]
    except ValueError as exc:
        return {"raised": str(exc)}
    return {"place": [pid, n], "blocks": torch.stack(blocks)}


def test_global_batches_at_world_4_gives_model_peers_one_block():
    """2 x 2, rank = 2 * data + model: data peers take disjoint blocks of
    the global batch, model peers the same one; a loader placed by its
    rank (the default place of one process a host) raises on every rank
    instead of training each model peer on another batch."""
    ranks = run_world(_world_batches, 4, False, timeout=120)
    assert [r["place"] for r in ranks] == [[0, 2], [0, 2], [1, 2], [1, 2]]
    assert torch.equal(ranks[0]["blocks"], ranks[1]["blocks"])
    assert torch.equal(ranks[2]["blocks"], ranks[3]["blocks"])
    for a, b in zip(ranks[0]["blocks"], ranks[2]["blocks"]):
        assert not set(a.tolist()) & set(b.tolist())
    wrong = run_world(_world_batches, 4, True, timeout=120)
    assert all("mesh_place" in r["raised"] for r in wrong)


KW = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, seq_len=16,
          dtype="float32")


def test_fit_resumes_bitwise_through_skip_and_the_fabric(tmp_path):
    """The notebook recipe: ShardedLoader -> prefetch -> global_batches
    feeds fit, which saves through the fabric; a restore resumes with the
    O(1) ``loader.skip`` and ``skip_batches=False``, bitwise equal to the
    straight run (and to the islice fast-forward)."""
    cfg = burnin.BurninConfig(**KW)
    tokens = np.random.default_rng(8).integers(
        0, cfg.vocab, (48, cfg.seq_len)).astype(np.int64)
    tx = trainer.make_optimizer(trainer.TrainerConfig(
        lr=1e-2, warmup_steps=2, decay_steps=10))
    step = trainer.make_train_step(partial(burnin.loss_fn, cfg=cfg), tx)

    def fresh():
        return trainer.init_state(
            burnin.init_params(cfg, seed=3, device="cpu"), tx)

    def pipeline(ld):
        return data.global_batches(
            data.prefetch(ld, to_device=lambda b: b[0]), device="cpu")

    def ld():
        return data.ShardedLoader(data.ArraySource(tokens), batch_size=4,
                                  seed=6, process_id=0, num_processes=1)

    abstract = trainer.abstract_state(fresh()["params"], tx)
    with CheckpointFabric(str(tmp_path), registry=Registry()) as fab:
        straight = trainer.fit(fresh(), pipeline(ld()), steps=7,
                               step_fn=step, checkpoints=fab, save_every=4)
        restored = [trainer.load_state(fab.restore(4, abstract=abstract), tx)
                    for _ in range(2)]
    resumed_loader = ld()
    resumed_loader.skip(restored[0]["step"])
    resumed = trainer.fit(restored[0], pipeline(resumed_loader), steps=7,
                          step_fn=step, skip_batches=False)
    replayed = trainer.fit(restored[1], pipeline(ld()), steps=7,
                           step_fn=step)
    want = _flatten(trainer.checkpoint_tree(straight))[0]
    for other in (resumed, replayed):
        got = _flatten(trainer.checkpoint_tree(other))[0]
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(got, want))
