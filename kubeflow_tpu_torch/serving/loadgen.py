"""Trace-driven open-loop load generator for the serving bench.

A copy of ``kubeflow_tpu/serving/loadgen.py`` (``Phase``,
``generate_trace``, ``burst_trace``, the gateway's trailing-window rates
``observed_rate`` and ``model_load``) over the port's ``Request``.

Open loop means arrivals are scheduled by the trace alone — a slow
server does not slow the generator down, so overload shows up as
queueing in the latency percentiles instead of silently throttling the
offered load (the closed-loop fallacy). Seeded end to end: the same
seed always produces the same trace, so bench rounds are comparable and
tests are deterministic.

A trace is a list of phases, each an (duration, rate) pair; arrivals
inside a phase are Poisson (exponential gaps) at that rate. The default
``burst_trace`` is the scale-from-zero story: silence → burst → cool —
exactly the shape that exercises park, warm restore, and scale-down.

Two seeded dimensions make so the paged-KV +
prefill/decode + multi-model engine is drive-able under the same open
loop:

- **Prompt lengths**: ``prompt_tokens``/``prompt_jitter`` give every
  request a prompt, and ``long_prompt_frac``/``long_prompt_tokens``
  mix in a heavy tail (the bimodal short/long mixture that exercises
  chunked prefill vs head-of-line).
- **Model ids**: ``models`` is a weighted ``{model_id: weight}``
  distribution stamped per request (what the gateway would route on).

Both default OFF, and the generator draws from the RNG **only when a
dimension is enabled** — so an existing seed produces the exact same
trace with or without them (determinism-by-seed is tested both ways).
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from kubeflow_tpu_torch.serving.engine import DEFAULT_MODEL, Request


@dataclass(frozen=True)
class Phase:
    duration: float            # seconds of trace time
    rate: float                # requests/sec (0 = silence)


def generate_trace(phases: list, *, seed: int = 0,
                   tokens_out: int = 8,
                   tokens_jitter: int = 0,
                   prompt_tokens: int = 0,
                   prompt_jitter: int = 0,
                   long_prompt_frac: float = 0.0,
                   long_prompt_tokens: int = 0,
                   models: dict | None = None) -> list:
    """Phases → arrival-sorted ``Request`` list. ``tokens_jitter`` adds
    uniform spread around ``tokens_out`` (continuous batching only pays
    off when request lengths differ — a jitter of 0 degenerates to
    static batching). ``prompt_tokens``/``long_prompt_*`` shape the
    prefill load; ``models`` weights the model-id mix."""
    rng = random.Random(seed)
    model_ids, model_weights = (), ()
    if models:
        model_ids = tuple(sorted(models))
        model_weights = tuple(models[m] for m in model_ids)
    requests: list = []
    t = 0.0
    rid = 0
    for phase in phases:
        end = t + phase.duration
        if phase.rate <= 0:
            t = end
            continue
        while True:
            t += rng.expovariate(phase.rate)
            if t >= end:
                t = end
                break
            toks = tokens_out
            if tokens_jitter:
                toks = max(1, tokens_out + rng.randint(-tokens_jitter,
                                                       tokens_jitter))
            prompt = prompt_tokens
            if long_prompt_frac and rng.random() < long_prompt_frac:
                prompt = long_prompt_tokens
            if prompt and prompt_jitter:
                prompt = max(1, prompt + rng.randint(-prompt_jitter,
                                                     prompt_jitter))
            model = DEFAULT_MODEL
            if model_ids:
                model = rng.choices(model_ids, weights=model_weights)[0]
            requests.append(Request(rid=rid, arrival=t, tokens_out=toks,
                                    prompt_tokens=max(0, prompt),
                                    model=model))
            rid += 1
    return requests


def burst_trace(*, seed: int = 0, warm_rate: float = 2.0,
                burst_rate: float = 20.0, warm_sec: float = 2.0,
                burst_sec: float = 3.0, cool_sec: float = 1.0,
                tokens_out: int = 8, tokens_jitter: int = 4,
                **dims) -> list:
    """The canonical bench trace: a trickle, a burst, a cool-down.
    Extra keyword dimensions (prompt/model mixes) pass through to
    :func:`generate_trace`."""
    return generate_trace(
        [Phase(warm_sec, warm_rate), Phase(burst_sec, burst_rate),
         Phase(cool_sec, warm_rate / 2)],
        seed=seed, tokens_out=tokens_out, tokens_jitter=tokens_jitter,
        **dims)


def observed_rate(requests: list, now: float, *,
                  window: float = 1.0) -> float:
    """Trailing-window request rate at trace time ``now`` — what a
    serving gateway would stamp as the observed-rate annotation."""
    lo = now - window
    n = sum(1 for r in requests if lo < r.arrival <= now)
    return n / window if window > 0 else 0.0


def model_load(requests: list, now: float, *,
               window: float = 1.0) -> dict:
    """Per-model trailing-window rates at trace time ``now`` — what the
    gateway stamps into the per-model load annotations the autoscaler
    and JWA read (the multiplexing signal)."""
    lo = now - window
    counts: dict = {}
    for r in requests:
        if lo < r.arrival <= now:
            model = getattr(r, "model", DEFAULT_MODEL)
            counts[model] = counts.get(model, 0) + 1
    return {m: n / window for m, n in counts.items()} if window > 0 else {}
