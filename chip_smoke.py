#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and hold its
kernels against their plain versions.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and ``nvidia-smi``; it imports ``kubeflow_tpu_torch``
from the checkout and nothing of JAX or ``kubeflow_tpu``. Each phase
prints one JSON line; any failure raises and exits non-zero before the
last line. With no CUDA device it exits 1 and prints no result.

1. device  — the card's name and power limit (``nvidia-smi``); TF32 off
   for every float32 product (``allow_tf32 = False``), so float32
   comparisons are float32.
2. build   — every ``.cu`` source of the package, one ``nvcc`` each, in
   parallel; seconds and ptxas's register / spill lines.
3. kernels — each kernel against its plain PyTorch version at the
   shapes the serving path gives it (and the edge shapes the port
   promises), tolerances enforced; at the decode shape the kernel, the
   plain version and one PyTorch library call timed with CUDA events
   (median of 30 batches of 10 back-to-back calls, after 5 warm-up
   calls), and the kernel's device time read by ``torch.profiler`` too.
4. model   — the full-width burn-in config through ``forward`` with
   ``attention="flash"`` and ``"xla"`` (plain dense) on the same seeded
   weights and tokens; logits held together within a stated bf16
   tolerance; the flash forward launches the kernel once per layer.
5. serving — the main path: ``ServingEngine`` cold start, model
   registration and swaps, a seeded open-loop trace, ``park`` and
   ``warm_restore``, a replay. Launch counts are zeroed just before and
   read just after, and must equal one per layer for every forward the
   engine ran. Then the decode step is timed and profiled, and the
   restored engine's argmax is checked against the dense forward.

Then the ``{"kernels": [...]}`` line, the card line, and the result line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace

# H100 SXM published dense peaks (NVIDIA data sheet): the bound a kernel
# is held against, with the card's power limit printed beside it.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_SEC = 3.35e12

# The serving config at full width: BENCH_MODEL's widths (bench.py) at
# seq_len 1024 (the decode program runs forward on [max_batch, seq_len],
# and 1025 breaks the flash contract); depth uncut.
MODEL = dict(vocab=8192, d_model=2048, n_heads=16, n_layers=8, d_ff=16384,
             seq_len=1024, attention="flash", dtype="bfloat16")
MAX_BATCH = 8
PREFILL_CHUNK = 32

# Kernel shapes: the decode step's, the prefill chunk's, several tiles
# past the JAX block (s > 1024), and the f32 / head-dim-64 / full path.
KERNEL_CASES = [
    ("decode", (MAX_BATCH, 1024, 16, 128), "bfloat16", True),
    ("prefill_chunk", (1, PREFILL_CHUNK, 16, 128), "bfloat16", True),
    ("multi_tile", (2, 2048, 4, 128), "bfloat16", True),
    ("f32_full_d64", (2, 256, 4, 64), "float32", False),
]
# O: bf16 outputs may differ by one bf16 ulp at |O| < 2 (2**-7) from P
# rounded against a running rather than the final max: 2e-2. f32: only
# the summation order differs: 1e-4. lse is f32 from f32 scores in both.
TOL_O = {"bfloat16": 2e-2, "float32": 1e-4}
TOL_LSE = 1e-3
# Flash vs dense logits at full width: the dense path rounds scaled logits
# and probabilities to bf16, the flash path keeps scores in f32 and rounds
# P against a running max; the gap compounds over 8 residual layers
# (measured 0.023 max, 0.0033 mean on an 8-layer d_model-512 config).
TOL_LOGITS_MAX = 0.125
TOL_LOGITS_MEAN = 0.01


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, torch, *, warmup=5, runs=30, batch=10) -> float:
    """Device time of one call of ``fn``: the median over ``runs`` of
    ``batch`` calls enqueued back to back between two CUDA events,
    divided by ``batch``, after ``warmup`` calls. Back to back, the
    host enqueues the next call while the card runs this one, so the
    wrapper's host time stays out of the reading while the card is the
    slower of the two."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def _device_rows(prof, calls: int) -> list:
    """(device ms per call, kernel name, launches per call) of every
    device kernel a ``torch.profiler`` run saw, largest first."""
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
        if dev_us and ev.device_type.name == "CUDA":
            rows.append((dev_us / calls / 1e3, ev.key, ev.count // calls))
    rows.sort(reverse=True)
    return rows


def profiled_ms(fn, torch, *, runs=20) -> float | None:
    """Device time per call of ``fn`` as ``torch.profiler`` reads it: the
    kernels' own time, without host dispatch. None if the profiler saw
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    rows = _device_rows(prof, runs)
    return sum(r[0] for r in rows) if rows else None


def attention_bound_ms(shape, dtype: str, causal: bool) -> tuple:
    """Least time for one flash forward on these inputs: q, k, v read
    once, o and lse written once, against the causal (or full) products
    QK^T and PV these inputs need."""
    b, s, h, d = shape
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = 4 * b * s * h * d * elt + b * h * s * 4
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * pairs * d
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_SEC, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(torch, fa) -> dict:
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1234)
    out = {}
    for name, shape, dtype, causal in KERNEL_CASES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(getattr(torch, dtype)) for _ in range(3))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ro, rlse = fa.flash_attention_reference(q, k, v, causal=causal)
        err_o = (o.float() - ro.float()).abs().max().item()
        err_lse = (lse - rlse).abs().max().item()
        ok = (bool(torch.isfinite(o).all()) and err_o <= TOL_O[dtype]
              and err_lse <= TOL_LSE)
        row = {"phase": "kernels", "case": name, "shape": list(shape),
               "dtype": dtype, "causal": causal, "max_err_o": err_o,
               "max_err_lse": err_lse, "tol_o": TOL_O[dtype],
               "tol_lse": TOL_LSE, "ok": ok}
        if name == "decode":
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            row["ms"] = time_ms(
                lambda: fa.flash_attention_fwd(q, k, v, causal=causal), torch)
            row["profiler_ms"] = profiled_ms(
                lambda: fa.flash_attention_fwd(q, k, v, causal=causal), torch)
            row["plain_ms"] = time_ms(
                lambda: fa.flash_attention_reference(q, k, v, causal=causal),
                torch)
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=causal),
                torch)
            row["bound_ms"], row["bound_by"] = attention_bound_ms(
                shape, dtype, causal)
        emit(row)
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"at {name}: {row}")
        out[name] = row
    return out


def phase_model(torch, fa, burnin) -> None:
    cfg = burnin.BurninConfig(**MODEL)
    dense = replace(cfg, attention="xla")
    params = burnin.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (MAX_BATCH, cfg.seq_len),
                           generator=gen, device="cuda")
    with torch.inference_mode():
        before = fa.LAUNCHES
        flash_logits = burnin.forward(params, tokens, cfg)
        torch.cuda.synchronize()
        launches = fa.LAUNCHES - before
        dense_logits = burnin.forward(params, tokens, dense)
    diff = (flash_logits - dense_logits).abs()
    last = dense_logits[:, -1]
    top2 = last.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > TOL_LOGITS_MAX
    argmax_equal = bool((flash_logits[:, -1].argmax(-1)[clear]
                         == last.argmax(-1)[clear]).all())
    row = {"phase": "model", "config": MODEL,
           "shape": list(flash_logits.shape),
           "finite": bool(torch.isfinite(flash_logits).all()),
           "max_abs_diff": diff.max().item(),
           "mean_abs_diff": diff.mean().item(),
           "tol_max": TOL_LOGITS_MAX, "tol_mean": TOL_LOGITS_MEAN,
           "logit_std": dense_logits.std().item(),
           "kernel_launches": launches, "n_layers": cfg.n_layers,
           "clear_margin_rows": int(clear.sum()),
           "argmax_equal_where_clear": argmax_equal}
    emit(row)
    if not (row["finite"]
            and list(flash_logits.shape) == [MAX_BATCH, cfg.seq_len,
                                             cfg.vocab]
            and row["max_abs_diff"] <= TOL_LOGITS_MAX
            and row["mean_abs_diff"] <= TOL_LOGITS_MEAN
            and launches == cfg.n_layers and argmax_equal):
        raise AssertionError(f"model phase failed: {row}")
    del params, flash_logits, dense_logits
    torch.cuda.empty_cache()


def profile_decode(torch, engine, tokens) -> dict:
    """Device time by kernel over three decode steps (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            engine._step_fn(engine._params, tokens).cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    rows = _device_rows(prof, 3)
    busy_ms = sum(r[0] for r in rows)
    return {"wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if rows else None,
            "top_kernels": [{"name": k[:90], "ms_per_step": round(ms, 4),
                             "calls_per_step": n} for ms, k, n in rows[:12]]}


def phase_serving(torch, fa, burnin, engine_mod, loadgen) -> dict:
    cfg = burnin.BurninConfig(**MODEL)
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0                      # ---- the main path starts here
    engine = engine_mod.ServingEngine(
        cfg, max_batch=MAX_BATCH,
        options=engine_mod.EngineOptions(prefill_chunk=PREFILL_CHUNK))
    cold_sec = engine.cold_start(seed=0)
    # Two more models behind the replica: cold-load both, which demotes
    # "default" (two resident slots) to a host-resident warm standby;
    # then swap it back warm, as bench.py's data plane does.
    engine.register_model("alt-a")
    engine.register_model("alt-b")
    engine.use_model("alt-a")
    engine.use_model("alt-b")
    engine.use_model("default")
    warm_swap_sec = engine.models.entry("default").warm_swap_sec
    cold_model_sec = engine.models.entry("alt-a").cold_init_sec
    launches0 = fa.LAUNCHES
    trace = loadgen.burst_trace(
        seed=11, warm_rate=10.0, burst_rate=80.0, warm_sec=1.0,
        burst_sec=0.5, cool_sec=1.0, tokens_out=8, tokens_jitter=4,
        long_prompt_frac=0.05, long_prompt_tokens=96,
        models={"default": 18, "alt-a": 1})
    report = engine.serve(trace)
    serve_launches = fa.LAUNCHES - launches0
    engine.kv.assert_consistent()
    ckpt = engine.park()
    restore_sec = engine.warm_restore()
    replay = engine.serve([engine_mod.Request(rid=10_000 + i, arrival=0.0,
                                              tokens_out=4)
                           for i in range(MAX_BATCH)])
    torch.cuda.synchronize()
    main_launches = fa.LAUNCHES          # ---- the main path ends here
    reg = engine.models
    forwards = (2 * (reg.swaps_cold + reg.swaps_warm) + report.steps
                + report.prefill_chunks + replay.steps
                + replay.prefill_chunks)
    expect_serve = cfg.n_layers * (report.steps + report.prefill_chunks
                                   + 2 * report.model_swaps)
    lat = sorted(c.latency for c in report.completions)
    row = {"phase": "serving", "requests": len(trace),
           "completed": len(report.completions),
           "tokens_out": report.tokens,
           "tokens_per_sec": report.tokens_per_sec,
           "p50_latency_sec": report.latency_percentile(0.50),
           "p99_latency_sec": report.latency_percentile(0.99),
           "max_latency_sec": lat[-1] if lat else None,
           "wall_sec": report.wall_sec,
           "decode_steps": report.steps,
           "batch_occupancy": report.batch_occupancy,
           "prefill_chunks": report.prefill_chunks,
           "model_swaps": report.model_swaps,
           "kv_violations": engine.kv.violations,
           "kv_used_blocks_after": engine.kv.used_blocks,
           "kv_peak_pressure": report.kv_peak_pressure,
           "cold_start_sec": cold_sec, "cold_model_sec": cold_model_sec,
           "warm_swap_sec": warm_swap_sec, "warm_restore_sec": restore_sec,
           "parked_checkpoint": ckpt,
           "replay_completed": len(replay.completions),
           "swaps": reg.debug_info()["swaps"],
           "serve_launches": serve_launches,
           "serve_launches_expected": expect_serve,
           "main_path_launches": main_launches,
           "main_path_launches_expected": cfg.n_layers * forwards,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    emit(row)
    if not (row["completed"] == row["requests"] > 0
            and row["kv_violations"] == 0 and row["kv_used_blocks_after"] == 0
            and row["model_swaps"] >= 1
            and serve_launches == expect_serve
            and main_launches == cfg.n_layers * forwards > 0
            and row["replay_completed"] == MAX_BATCH):
        raise AssertionError(f"serving phase failed: {row}")

    # The decode step alone, host clock around work that ends in a sync.
    tokens = torch.zeros((MAX_BATCH, cfg.seq_len), dtype=torch.int64,
                         device="cuda")
    step_ms = []
    for _ in range(12):
        t0 = time.perf_counter()
        engine._step_fn(engine._params, tokens).cpu()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    prof = profile_decode(torch, engine, tokens)
    emit({"phase": "decode_step", "shape": [MAX_BATCH, cfg.seq_len],
          "median_ms": statistics.median(step_ms[2:]),
          "min_ms": min(step_ms[2:]), "max_ms": max(step_ms[2:]),
          "runs": len(step_ms) - 2, **prof})

    # The restored engine's answers against the dense forward.
    gen = torch.Generator(device="cuda").manual_seed(11)
    probe = torch.randint(0, cfg.vocab, (MAX_BATCH, cfg.seq_len),
                          generator=gen, device="cuda")
    got = engine._step_fn(engine._params, probe)
    with torch.inference_mode():
        ref = burnin.forward(engine._params, probe,
                             replace(cfg, attention="xla"))[:, -1]
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > TOL_LOGITS_MAX
    equal = bool((got[clear] == ref.argmax(-1)[clear]).all())
    emit({"phase": "engine_output", "clear_margin_rows": int(clear.sum()),
          "argmax_equal_where_clear": equal,
          "shape": list(got.shape)})
    if not (equal and list(got.shape) == [MAX_BATCH]):
        raise AssertionError("engine argmax disagrees with the dense forward")
    return {"launches": main_launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from kubeflow_tpu_torch.models import burnin
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.serving import engine as engine_mod
    from kubeflow_tpu_torch.serving import loadgen

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "allow_tf32": False})

    t0 = time.perf_counter()
    compiled = _build.build()
    emit({"phase": "build", "sources": _build.sources(), "compiled": compiled,
          "build_sec": time.perf_counter() - t0,
          "ptxas": [line.strip() for log in _build.BUILD_LOG.values()
                    for line in log.splitlines()
                    if "registers" in line or "spill" in line]})

    kernels = phase_kernels(torch, fa)
    phase_model(torch, fa, burnin)
    serving = phase_serving(torch, fa, burnin, engine_mod, loadgen)

    decode = kernels["decode"]
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "kubeflow_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "kubeflow_tpu/ops/flash_attention.py:67",
        "launches": serving["launches"],
        "max_abs_err": max(row["max_err_o"] for row in kernels.values()),
        "max_err_o": max(row["max_err_o"] for row in kernels.values()),
        "max_err_lse": max(row["max_err_lse"] for row in kernels.values()),
        "ms": decode["ms"], "profiler_ms": decode["profiler_ms"],
        "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"]}]})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
