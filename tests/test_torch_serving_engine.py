"""The port's serving engine: the JAX engine's tests, run on the port
with ``device="cpu"``, the KV block pool's invariants on the port's copy,
a lane-by-lane comparison with the JAX engine on one trace, and the rule
that the engine never falls back to the CPU on its own."""

import random
import time

import pytest
import torch

from kubeflow_tpu.models.burnin import BurninConfig as JaxBurninConfig
from kubeflow_tpu.serving.engine import EngineOptions as JaxEngineOptions
from kubeflow_tpu.serving.engine import Request as JaxRequest
from kubeflow_tpu.serving.engine import ServingEngine as JaxServingEngine
from kubeflow_tpu_torch.models.burnin import BurninConfig
from kubeflow_tpu_torch.runtime import slo
from kubeflow_tpu_torch.runtime.metrics import Registry
from kubeflow_tpu_torch.serving.engine import (
    DEFAULT_MODEL,
    EngineOptions,
    Request,
    ServingEngine,
)
from kubeflow_tpu_torch.serving.kvcache import (
    BlockTable,
    KVBlockPool,
    KVCacheError,
)
from kubeflow_tpu_torch.serving.loadgen import Phase, burst_trace, generate_trace

# The shapes are tiny: one intra-op thread keeps torch's OpenMP pool
# from spinning on cores that the other test workers share.
torch.set_num_threads(1)

TINY_KW = dict(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
               seq_len=32)
TINY = BurninConfig(**TINY_KW)


def _engine(max_batch=2, **options):
    return ServingEngine(TINY, max_batch=max_batch, use_mesh=False,
                         options=EngineOptions(**options), device="cpu")


# ---- KV block pool -----------------------------------------------------------


def test_blocks_needed_is_worst_case_and_at_least_one():
    pool = KVBlockPool(8, block_size=16)
    assert pool.blocks_needed(0, 0) == 1          # a slot is never free
    assert pool.blocks_needed(0, 16) == 1
    assert pool.blocks_needed(1, 16) == 2         # rounds up
    assert pool.blocks_needed(100, 28) == 8


def test_admit_release_roundtrip_accounting():
    reg = Registry()
    pool = KVBlockPool(8, block_size=16, registry=reg)
    table = pool.admit(1, prompt_tokens=20, tokens_out=10)
    assert isinstance(table, BlockTable)
    assert len(table.blocks) == 2 and table.capacity_tokens == 32
    assert pool.used_blocks == 2 and pool.free_blocks == 6
    assert pool.pressure == pytest.approx(0.25)
    assert reg.gauge("tpu_serving_kv_blocks_used").labels().value == 2.0
    assert reg.gauge("tpu_serving_kv_blocks_total").labels().value == 8.0
    freed = pool.release(1)
    assert freed == 2 and pool.used_blocks == 0
    assert reg.gauge("tpu_serving_kv_blocks_used").labels().value == 0.0
    pool.assert_consistent()
    assert pool.violations == 0


def test_admission_is_all_or_nothing_under_pressure():
    pool = KVBlockPool(4, block_size=16)
    assert pool.admit(1, 40, 8) is not None       # 3 blocks
    before = pool.free_blocks
    assert pool.admit(2, 20, 16) is None          # needs 3, only 1 free
    assert pool.free_blocks == before             # nothing partially taken
    assert pool.rejections == 1
    assert pool.blocks_short(20, 16) == 2
    pool.release(1)
    assert pool.admit(2, 20, 16) is not None      # backpressure, not a drop
    pool.assert_consistent()
    assert pool.violations == 0


def _double_admit(pool):
    pool.admit(7, 0, 8)
    pool.admit(7, 0, 8)


def _append_past_reservation(pool):
    table = pool.admit(1, prompt_tokens=0, tokens_out=8)   # 1 block of 8
    table.append(8)
    table.append(1)


@pytest.mark.parametrize("breach", [_double_admit, _append_past_reservation],
                         ids=["double_admit", "append_past_reservation"])
def test_protocol_breach_raises(breach):
    with pytest.raises(KVCacheError):
        breach(KVBlockPool(4, block_size=8))


@pytest.mark.parametrize("bad", [dict(total_blocks=0),
                                 dict(total_blocks=4, block_size=0)])
def test_pool_rejects_non_positive_sizes(bad):
    with pytest.raises(ValueError):
        KVBlockPool(**bad)


def test_release_unknown_or_double_is_idempotent_noop():
    pool = KVBlockPool(4, block_size=16)
    pool.admit(1, 0, 8)
    assert pool.release(99) == 0                  # never admitted
    assert pool.release(1) == 1
    assert pool.release(1) == 0                   # double release
    pool.assert_consistent()
    assert pool.violations == 0


def test_seeded_fault_storm_never_oversells():
    pool = KVBlockPool(16, block_size=8)
    rng = random.Random(5)
    live = []
    for i in range(400):
        roll = rng.random()
        if roll < 0.5:
            if pool.admit(i, rng.randint(0, 40), rng.randint(1, 12)):
                live.append(i)
        elif roll < 0.75 and live:
            pool.release(live.pop(rng.randrange(len(live))))
        elif roll < 0.9:
            pool.release(rng.randint(-500, 500))  # hostile: unknown rid
        else:
            pool.admit(-i - 1, 10_000, 1)         # hostile: oversized
        if i % 40 == 0:
            pool.assert_consistent()
    for rid in live:
        pool.release(rid)
    pool.assert_consistent()
    assert pool.violations == 0
    assert pool.used_blocks == 0                  # nothing leaked
    assert pool.rejections > 0


def test_assert_consistent_counts_a_corrupted_free_list():
    pool = KVBlockPool(4, block_size=8)
    table = pool.admit(1, 0, 8)
    pool._free.append(table.blocks[0])            # owned AND free
    with pytest.raises(KVCacheError):
        pool.assert_consistent()
    assert pool.violations > 0


# ---- engine: admission, prefill, backpressure --------------------------------


def test_serve_mixed_prompts_and_models_completes_with_clean_kv():
    engine = _engine(max_batch=4, kv_block_size=8, prefill_chunk=8)
    engine.cold_start(seed=0)
    engine.register_model("alt")
    trace = generate_trace(
        [Phase(0.1, 80.0)], seed=3, tokens_out=4, tokens_jitter=2,
        prompt_tokens=0, long_prompt_frac=0.3, long_prompt_tokens=20,
        models={DEFAULT_MODEL: 3, "alt": 1})
    report = engine.serve(trace)
    assert len(report.completions) == len(trace)
    assert report.prefill_chunks > 0
    assert report.model_swaps >= 1
    engine.kv.assert_consistent()
    assert engine.kv.violations == 0
    assert engine.kv.used_blocks == 0             # all released at finish
    done_models = {c.model for c in report.completions}
    assert done_models == {r.model for r in trace}


def test_prefill_chunk_count_is_ceil_of_prompt_over_chunk():
    engine = _engine(kv_block_size=8, prefill_chunk=8)
    engine.cold_start(seed=0)
    report = engine.serve([Request(rid=0, arrival=0.0, tokens_out=2,
                                   prompt_tokens=20)])
    assert report.prefill_chunks == 3             # ceil(20 / 8)
    assert report.prefill_tokens == 20
    assert len(report.completions) == 1


def test_kv_backpressure_is_queue_wait_never_a_drop():
    engine = _engine(max_batch=4, kv_blocks=2, kv_block_size=8)
    engine.cold_start(seed=0)
    # Six single-block requests against a two-block pool: at most two
    # run at once, the rest wait in the queue — but every one finishes.
    trace = [Request(rid=i, arrival=0.0, tokens_out=6) for i in range(6)]
    report = engine.serve(trace)
    assert len(report.completions) == 6
    assert report.kv_rejections > 0
    assert engine.kv.violations == 0
    assert max(c.queue_wait for c in report.completions) > 0.0


def test_request_that_can_never_fit_raises_instead_of_spinning():
    engine = _engine(kv_blocks=2, kv_block_size=8)
    engine.cold_start(seed=0)
    with pytest.raises(KVCacheError):
        engine.serve([Request(rid=0, arrival=0.0, tokens_out=64)])


def test_serve_before_cold_start_still_raises():
    engine = _engine()
    with pytest.raises(RuntimeError):
        engine.serve([Request(rid=0, arrival=0.0)])


def test_completions_feed_the_serving_latency_sli():
    engine = _engine()
    engine.cold_start(seed=0)
    slo_engine = slo.install(slo.SloEngine(Registry(), environ={}))
    try:
        engine.serve([Request(rid=i, arrival=0.0, tokens_out=2)
                      for i in range(3)])
        sli = slo_engine.slis["serving_latency"]
    finally:
        slo.install(None)
    assert sli.total_good + sli.total_bad == 3


# ---- engine: park / restore spanning the queue -------------------------------


def test_requests_queued_during_park_complete_after_restore():
    """Requests submitted while the engine is parked survive the park and
    complete after warm restore, with queue_wait spanning the parked
    window."""
    engine = _engine()
    engine.cold_start(seed=0)
    engine.park()
    assert engine.parked
    params = engine.models.entry(DEFAULT_MODEL).host_params
    assert params["embed"].device.type == "cpu"
    engine.submit(Request(rid=1, arrival=0.0, tokens_out=3))
    engine.submit(Request(rid=2, arrival=0.0, tokens_out=3))
    time.sleep(0.08)
    engine.warm_restore()
    report = engine.serve([])
    assert {c.rid for c in report.completions} == {1, 2}
    assert min(c.queue_wait for c in report.completions) >= 0.08
    assert engine.kv.violations == 0


# ---- engine: model registry --------------------------------------------------


def test_warm_standby_lru_demotes_and_swaps_back_warm():
    engine = _engine(max_resident_models=1)
    engine.cold_start(seed=0)
    engine.register_model("alt")
    engine.use_model("alt")                       # cold: init
    alt = engine.models.entry("alt")
    assert alt.cold_init_sec is not None
    # With a one-model device budget, activating alt demoted default to
    # a host-resident warm standby with its fns retained.
    default = engine.models.entry(DEFAULT_MODEL)
    assert default.device_params is None
    assert default.host_params is not None and default.warm
    assert default.decode_fn is not None
    engine.use_model(DEFAULT_MODEL)               # warm: device transfer
    assert default.warm_swap_sec is not None
    assert engine.models.swaps_cold >= 1 and engine.models.swaps_warm >= 1


def test_use_model_while_parked_raises():
    engine = _engine()
    engine.cold_start(seed=0)
    engine.park()
    with pytest.raises(RuntimeError):
        engine.use_model("other")


def test_debug_info_exposes_kv_lanes_and_models():
    engine = _engine()
    engine.cold_start(seed=0)
    info = engine.debug_info()
    assert info["activeModel"] == DEFAULT_MODEL
    assert info["kv"]["violations"] == 0
    assert info["kv"]["totalBlocks"] == engine.kv.total_blocks
    assert info["lanes"]["decodeSlots"] == 2
    assert DEFAULT_MODEL in info["models"]["registered"]


# ---- the port against the JAX engine -----------------------------------------


def _lane_trace(request_cls):
    """Every request arrives at 0, so the loop's lane decisions depend on
    the trace alone, not on how fast the model runs."""
    return [request_cls(rid=i, arrival=0.0, tokens_out=2 + i % 3,
                        prompt_tokens=20 if i % 3 == 0 else 0,
                        model="alt" if i in (4, 5) else DEFAULT_MODEL)
            for i in range(9)]


def test_lanes_match_the_jax_engine_on_one_trace():
    opts = dict(kv_blocks=10, kv_block_size=8, prefill_chunk=8)
    ref = JaxServingEngine(JaxBurninConfig(**TINY_KW), max_batch=3,
                           use_mesh=False, options=JaxEngineOptions(**opts))
    port = _engine(max_batch=3, **opts)
    reports = []
    for engine, request_cls in ((ref, JaxRequest), (port, Request)):
        engine.cold_start(seed=0)
        engine.register_model("alt")
        reports.append(engine.serve(_lane_trace(request_cls)))
    want, got = reports

    def lanes(r):
        return (r.steps, r.prefill_chunks, r.prefill_tokens, r.model_swaps,
                r.kv_rejections, round(r.batch_occupancy, 9),
                [(c.rid, c.tokens, c.model) for c in r.completions])

    assert lanes(got) == lanes(want)
    assert got.kv_peak_pressure == want.kv_peak_pressure
    assert port.models.debug_info() == ref.models.debug_info()


def test_burst_trace_is_seeded_like_the_jax_loadgen():
    from kubeflow_tpu.serving.loadgen import burst_trace as jax_burst_trace

    kw = dict(seed=11, warm_sec=0.25, burst_sec=0.25, cool_sec=0.1,
              long_prompt_frac=0.05, long_prompt_tokens=96,
              models={"default": 18, "alt-a": 1})
    got = [(r.rid, r.arrival, r.tokens_out, r.prompt_tokens, r.model)
           for r in burst_trace(**kw)]
    want = [(r.rid, r.arrival, r.tokens_out, r.prompt_tokens, r.model)
            for r in jax_burst_trace(**kw)]
    assert got == want and got


# ---- where the engine runs ---------------------------------------------------


def test_no_device_and_no_cuda_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(TINY)


def test_explicit_cpu_keeps_weights_on_cpu():
    engine = _engine()
    engine.cold_start(seed=0)
    assert engine.device == torch.device("cpu")
    assert engine._params["layers"][0]["qkv"].device.type == "cpu"


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of this process alone, destroyed after."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), world_size=1, rank=0)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("use_mesh", [True, False])
def test_use_mesh_keeps_the_whole_tree_without_a_process_group(use_mesh):
    """No process group: the weights go whole to the engine's device,
    whatever ``use_mesh`` says, and there is no mesh."""
    engine = ServingEngine(TINY, max_batch=2, use_mesh=use_mesh,
                           device="cpu")
    engine.cold_start(seed=0)
    qkv = engine._params["layers"][0]["qkv"]
    assert engine.models.mesh is None and engine._ctl is None
    assert tuple(qkv.shape) == (32, 96)
    assert qkv.device == engine.device == torch.device("cpu")


@pytest.mark.parametrize("use_mesh", [True, False])
def test_use_mesh_in_a_world_of_one_keeps_the_whole_tree(world_of_one,
                                                         use_mesh):
    """A world of one process serves as with no group: no mesh, no
    control group, the whole tree, the same lanes (tests/
    test_torch_serving_sharded.py holds a world of 4)."""
    engine = ServingEngine(TINY, max_batch=2, use_mesh=use_mesh,
                           device="cpu")
    engine.cold_start(seed=0)
    assert engine.models.mesh is None and engine._ctl is None
    assert tuple(engine._params["layers"][0]["qkv"].shape) == (32, 96)
    report = engine.serve([Request(rid=0, arrival=0.0, tokens_out=2)])
    assert report.steps == 2 and len(report.completions) == 1


def test_serve_opens_one_serve_span():
    from kubeflow_tpu_torch.runtime.tracing import span

    engine = _engine()
    engine.cold_start(seed=0)
    with span("root") as root:
        engine.serve([Request(rid=0, arrival=0.0, tokens_out=2)])
    assert root.span_names() == ["serve"]
    serve = root.children[0]
    assert serve.attrs == {"requests": 1, "max_batch": 2}
    assert serve.status == "ok" and serve.duration > 0
    assert serve.trace_id == root.trace_id
    assert serve.parent_id == root.span_id
