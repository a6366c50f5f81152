"""The port's kernel cache (``kubeflow_tpu_torch.utils.compilecache``)
against the JAX package's XLA cache module on the same directories: the
same entry counts, readiness, seeding (with and without a manifest), hit
and miss verdicts and counters. What the port adds: its cache is
``ops/_build``'s library directory, which ``enable_persistent_cache``
moves (and an unusable directory leaves where it was), an entry is a
library (``*.so``; a ``.tmp`` file in flight is none), and the SDK's
``warm_idle`` seeds the cache before it builds."""

import json
import logging
import os
import shutil

import pytest
import torch

from kubeflow_tpu.utils import compilecache as jax_cc
from kubeflow_tpu_torch import sdk
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.runtime.metrics import global_registry
from kubeflow_tpu_torch.utils import compilecache as cc


@pytest.fixture(autouse=True)
def _keep_the_library_dir(monkeypatch):
    """Every test leaves ``_build`` where it found it."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)


def _libs(path, names):
    path.mkdir(parents=True, exist_ok=True)
    for name in names:
        (path / name).write_bytes(name.encode() * 64)
    return path


def test_the_contract_names_equal_the_reference(monkeypatch):
    for name in ("ENV_VAR", "SEED_DIR_ENV", "SEED_MANIFEST"):
        assert getattr(cc, name) == getattr(jax_cc, name)
    monkeypatch.setenv(cc.ENV_VAR, "/tmp/kftpu-cache-x")
    assert cc.default_cache_dir() == jax_cc.default_cache_dir() == \
        "/tmp/kftpu-cache-x"
    monkeypatch.setenv(cc.ENV_VAR, "~/kernels")
    assert cc.default_cache_dir() == jax_cc.default_cache_dir()
    # Unset, the cache is _build's own directory.
    monkeypatch.delenv(cc.ENV_VAR)
    assert cc.default_cache_dir() == str(_build.DEFAULT_BUILD_DIR)


@pytest.mark.parametrize("names", [[], ["a.so"], ["a.so", "b.so", "c.so"]])
def test_cache_entries_equal_the_reference(tmp_path, names):
    d = str(_libs(tmp_path / "c", names))
    assert cc.cache_entries(d) == jax_cc.cache_entries(d) == len(names)
    missing = str(tmp_path / "nope")
    assert cc.cache_entries(missing) == jax_cc.cache_entries(missing) == 0


def test_a_library_in_flight_is_no_entry(tmp_path):
    d = _libs(tmp_path / "c", ["a.so", "b.so.123.tmp", "notes.txt"])
    (d / "sub.so").mkdir()
    assert cc.cache_entries(str(d)) == 1
    assert jax_cc.cache_entries(str(d)) == 3  # every regular file


def test_cache_dir_ready_equals_the_reference(tmp_path):
    a_file = tmp_path / "f"
    a_file.write_text("x")
    for d in (tmp_path, tmp_path / "missing", a_file):
        assert cc.cache_dir_ready(str(d)) == jax_cc.cache_dir_ready(str(d))
    assert cc.cache_dir_ready(str(tmp_path))
    assert not cc.cache_dir_ready(str(a_file))


SEEDS = {
    "all": (["a.so", "b.so", "c.so"], None),
    "manifest": (["a.so", "b.so", "c.so"], ["a.so", "c.so", "gone.so"]),
    "bad_manifest": (["a.so", "b.so"], "{not json"),
    "not_a_list": (["a.so"], {"a.so": 1}),
}


@pytest.mark.parametrize("case", SEEDS)
def test_seed_cache_equals_the_reference(tmp_path, case):
    libs, manifest = SEEDS[case]
    results = []
    for name, module in (("port", cc), ("jax", jax_cc)):
        seed = _libs(tmp_path / name / "seed", libs)
        if manifest is not None:
            (seed / cc.SEED_MANIFEST).write_text(
                manifest if isinstance(manifest, str) else json.dumps(manifest))
        cache = _libs(tmp_path / name / "cache", ["b.so"])
        before = module.cache_stats()["seeded"]
        out = module.seed_cache(str(seed), str(cache))
        results.append((out, sorted(os.listdir(cache)),
                        module.cache_stats()["seeded"] - before))
    assert results[0] == results[1]
    out, listing, counted = results[0]
    assert counted == out["seeded"] and out["ready"]
    assert cc.SEED_MANIFEST not in listing
    assert not any(n.endswith(".tmp") for n in listing)
    assert (tmp_path / "port" / "cache" / "a.so").read_bytes() == \
        (tmp_path / "port" / "seed" / "a.so").read_bytes()


def test_seed_cache_no_ops_equal_the_reference(tmp_path, monkeypatch):
    monkeypatch.delenv(cc.SEED_DIR_ENV, raising=False)
    seed = str(_libs(tmp_path / "seed", ["a.so"]))
    cache = str(_libs(tmp_path / "cache", []))
    broken = tmp_path / "file"
    broken.write_text("x")
    for args in ((None, cache), (str(tmp_path / "none"), cache),
                 (seed, str(broken))):
        assert cc.seed_cache(*args) == jax_cc.seed_cache(*args)
    assert cc.seed_cache(seed, str(broken))["ready"] is False
    # The seed dir from the env.
    monkeypatch.setenv(cc.SEED_DIR_ENV, seed)
    assert cc.seed_cache(cache_dir=cache)["seeded"] == 1


def test_note_compile_and_the_counters_equal_the_reference():
    def counts():
        port = cc.cache_stats()
        want = jax_cc.cache_stats()
        return (port["hits"], port["misses"]), (want["hits"], want["misses"])

    def mirrored():
        text = global_registry.expose()
        return {name: next((float(line.split()[-1])
                            for line in text.splitlines()
                            if line.startswith(name + " ")), 0.0)
                for name in ("compile_cache_hits_total",
                             "compile_cache_misses_total")}

    before, mirror = counts(), mirrored()
    for entries in ((3, 3), (3, 4), (4, 3), (0, 0), (0, 3)):
        assert cc.note_compile(*entries) == jax_cc.note_compile(*entries)
    after = counts()
    assert [a - b for a, b in zip(after[0], before[0])] == \
        [a - b for a, b in zip(after[1], before[1])] == [3, 2]
    now = mirrored()
    assert now["compile_cache_hits_total"] - \
        mirror["compile_cache_hits_total"] == 3
    assert now["compile_cache_misses_total"] - \
        mirror["compile_cache_misses_total"] == 2


def test_enable_persistent_cache_moves_the_library_dir(tmp_path):
    d = cc.enable_persistent_cache(str(tmp_path / "kernels"))
    assert d == str(tmp_path / "kernels") and os.path.isdir(d)
    assert cc.cache_dir_ready(d)
    assert _build.BUILD_DIR == tmp_path / "kernels"
    assert _build.library_path(fa.SOURCE).parent == tmp_path / "kernels"
    # Idempotent.
    assert cc.enable_persistent_cache(d) == d
    assert _build.library_path(fa.SOURCE).parent == tmp_path / "kernels"


def test_enable_persistent_cache_from_the_env(tmp_path, monkeypatch):
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path / "pvc"))
    assert cc.enable_persistent_cache() == str(tmp_path / "pvc")
    assert _build.library_path(fa.BWD_SOURCE).parent == tmp_path / "pvc"


def test_an_unusable_dir_leaves_the_build_where_it_was(tmp_path, caplog):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    unusable = str(blocker / "cache")
    where = _build.library_path(fa.SOURCE)
    port0, jax0 = cc.setup_failures_total(), jax_cc.setup_failures_total()
    with caplog.at_level(logging.ERROR):
        for _ in range(2):
            assert cc.enable_persistent_cache(unusable) == \
                jax_cc.enable_persistent_cache(unusable) == unusable
    assert cc.setup_failures_total() - port0 == \
        jax_cc.setup_failures_total() - jax0 == 2
    ours = [r for r in caplog.records if r.name == cc.__name__]
    assert len(ours) == 1  # logged once a directory
    assert _build.library_path(fa.SOURCE) == where
    assert not cc.cache_dir_ready(unusable)


def test_warm_idle_seeds_the_cache_before_it_builds(tmp_path, monkeypatch):
    seed = _libs(tmp_path / "seed", ["x.so", "y.so"])
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path / "cache"))
    monkeypatch.setenv(cc.SEED_DIR_ENV, str(seed))
    monkeypatch.setattr(torch.cuda, "init", lambda: None)
    seen = []

    def build(items=None):
        seen.append((_build.BUILD_DIR, cc.cache_entries(str(_build.BUILD_DIR))))
        return []

    monkeypatch.setattr(_build, "build", build)
    claim = sdk.warm_idle(fetch_claim=lambda: "ns/nb/1",
                          _sleep=lambda _s: None)
    assert claim == "ns/nb/1"
    assert seen == [(tmp_path / "cache", 2)]
    shutil.rmtree(tmp_path / "cache")
