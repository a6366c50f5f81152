"""Low-overhead per-step training recorder.

The port of ``kubeflow_tpu/telemetry/profiler.py``, with its two device
calls in torch: the boundary sync waits on the loss tensor's card
(``torch.cuda.synchronize``; nothing for a CPU tensor), and the memory
high-water is ``torch.cuda.max_memory_allocated`` (``None`` on the CPU).

Always-on (``KFTPU_TELEMETRY``, default on): the hot path per step is
two ``perf_counter`` reads and a deque append. Rolling
windows are summarized — p50 step time, achieved MFU against a declared
peak, compile-vs-run split, collective-overlap attribution (fed from the
paired serialize-mode measurement, :mod:`sections`), HBM high-water —
never raw per-step streams.

Honest timing under async dispatch: the first observed step is recorded
separately as the compile-inclusive step (in the port: the first step's
allocations and kernel builds), and every ``sync_every``-th
step blocks on the step's output value so queued device work drains into
a measured step instead of accumulating invisibly. On window summaries
the p50 is robust to that boundary spike.
"""

from __future__ import annotations

import os
import time
from collections import deque

import torch

from kubeflow_tpu_torch import telemetry as _pkg

TELEMETRY_WINDOW_ENV = "KFTPU_TELEMETRY_WINDOW"
DEFAULT_WINDOW = 32


def window_steps(environ=os.environ) -> int:
    raw = environ.get(TELEMETRY_WINDOW_ENV)
    try:
        value = int(raw) if raw is not None else DEFAULT_WINDOW
    except ValueError:
        return DEFAULT_WINDOW
    return max(2, value)


def overlap_fraction(overlapped_sec: float, serialized_sec: float) -> float:
    """Fraction of the serialized step hidden by comm/compute overlap:
    ``clamp((t_serialized - t_overlapped) / t_serialized, 0, 1)``."""
    if serialized_sec <= 0.0:
        return 0.0
    return max(0.0, min(1.0, (serialized_sec - overlapped_sec) / serialized_sec))


def _p50(values) -> float:
    ordered = sorted(values)
    n = len(ordered)
    mid = n // 2
    if n % 2:
        return ordered[mid]
    return 0.5 * (ordered[mid - 1] + ordered[mid])


def hbm_high_water_bytes(device=None) -> int | None:
    """Peak bytes the caching allocator has handed out on a CUDA device
    (``torch.cuda.max_memory_allocated``; ``None``: the current card), or
    None on the CPU, which keeps no such count (the JAX package returns
    None there too)."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.cuda.current_device()
    elif torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def _sync(value) -> None:
    """Wait for the work that produces ``value``: its card's queued
    kernels for a CUDA tensor, nothing for anything else (a CPU tensor
    is computed by the time it exists)."""
    if isinstance(value, torch.Tensor) and value.is_cuda:
        torch.cuda.synchronize(value.device)


class StepProfiler:
    """Per-step recorder for one training run of one model family.

    ``flops_per_step`` and ``peak_flops`` are in FLOPs and FLOP/s; when
    both are known the summary carries achieved MFU with ``mfu_basis``
    naming what the peak was measured against (``"accelerator"``: the
    card's published dense peak; a caller that measured its peak some
    other way names that basis rather than publishing a vacuous 0).
    """

    def __init__(
        self,
        family: str,
        *,
        flops_per_step: float = 0.0,
        tokens_per_step: int = 0,
        peak_flops: float = 0.0,
        mfu_basis: str = "accelerator",
        window: int | None = None,
        sync_every: int | None = None,
        clock=time.perf_counter,
        environ=os.environ,
    ):
        self.family = family
        self.flops_per_step = float(flops_per_step)
        self.tokens_per_step = int(tokens_per_step)
        self.peak_flops = float(peak_flops)
        self.mfu_basis = mfu_basis
        self.window = window if window is not None else window_steps(environ)
        self.sync_every = sync_every if sync_every is not None else self.window
        self._clock = clock
        self._environ = environ
        self._recent: deque[float] = deque(maxlen=self.window)
        self.steps = 0                  # measured steps (post-compile)
        self.last_step = 0              # caller's global step counter
        self.first_step_sec: float | None = None   # compile-inclusive
        self.run_sec_total = 0.0
        self.overlap: float | None = None
        self.serialized_step_sec: float | None = None
        self.hbm_bytes: int | None = None
        self._t0: float | None = None

    # ------------------------------------------------------------ hot path

    def enabled(self) -> bool:
        return _pkg.is_enabled(self._environ)

    def start(self) -> None:
        """Mark step start (pairs with :meth:`stop`)."""
        if self.enabled():
            self._t0 = self._clock()

    def stop(self, step: int | None = None, sync_value=None) -> None:
        if self._t0 is None:
            return
        t0, self._t0 = self._t0, None
        seconds = self._clock() - t0
        self.observe(step if step is not None else self.last_step + 1,
                     seconds, sync_value=sync_value)

    def observe(self, step: int, seconds: float, sync_value=None) -> None:
        """Record one step's wall time. ``sync_value`` (typically the
        loss) is blocked on at the first step and every ``sync_every``-th
        step so queued async work drains into a measured step."""
        if not self.enabled():
            return
        boundary = self.steps == 0 or (self.steps % self.sync_every == 0)
        if sync_value is not None and boundary:
            t_sync = self._clock()
            _sync(sync_value)
            seconds += self._clock() - t_sync
        self.last_step = int(step)
        if self.first_step_sec is None:
            # The first step pays allocation and kernel builds; keep it
            # out of the rolling window so MFU reflects steady state.
            self.first_step_sec = seconds
            return
        self.steps += 1
        self.run_sec_total += seconds
        self._recent.append(seconds)

    # ------------------------------------------------------------ annotate

    def note_overlap(self, fraction: float,
                     serialized_step_sec: float | None = None) -> None:
        self.overlap = max(0.0, min(1.0, float(fraction)))
        if serialized_step_sec is not None:
            self.serialized_step_sec = float(serialized_step_sec)

    def note_hbm(self, device=None) -> None:
        peak = hbm_high_water_bytes(device)
        if peak is not None:
            self.hbm_bytes = max(self.hbm_bytes or 0, peak)

    # ------------------------------------------------------------ summary

    def step_p50_sec(self) -> float | None:
        if not self._recent:
            return None
        return _p50(self._recent)

    def mfu(self) -> float | None:
        p50 = self.step_p50_sec()
        if p50 is None or p50 <= 0 or not self.flops_per_step \
                or not self.peak_flops:
            return None
        return (self.flops_per_step / p50) / self.peak_flops

    def compile_sec(self) -> float | None:
        """Compile share of the first step: first-step wall minus the
        steady-state p50 (clamped — a cache hit can make them equal)."""
        if self.first_step_sec is None:
            return None
        p50 = self.step_p50_sec() or 0.0
        return max(0.0, self.first_step_sec - p50)

    def summary(self) -> dict:
        p50 = self.step_p50_sec()
        mean = (sum(self._recent) / len(self._recent)) if self._recent \
            else None
        achieved = (self.flops_per_step / p50) if p50 and self.flops_per_step \
            else None
        tokens_per_sec = (self.tokens_per_step / p50) \
            if p50 and self.tokens_per_step else None
        return {
            "family": self.family,
            "step": self.last_step,
            "steps_measured": self.steps,
            "window": self.window,
            "step_p50_sec": p50,
            "step_mean_sec": mean,
            "achieved_tflops": achieved / 1e12 if achieved else None,
            "mfu": self.mfu(),
            "mfu_basis": self.mfu_basis if self.mfu() is not None else None,
            "tokens_per_sec": tokens_per_sec,
            "first_step_sec": self.first_step_sec,
            "compile_sec": self.compile_sec(),
            "overlap_fraction": self.overlap,
            "serialized_step_sec": self.serialized_step_sec,
            "hbm_high_water_bytes": self.hbm_bytes,
        }
