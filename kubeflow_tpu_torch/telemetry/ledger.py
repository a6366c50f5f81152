"""Per-family x shape efficiency ledger — the scheduler placement signal.

A copy of ``kubeflow_tpu/telemetry/ledger.py`` (it has no JAX): the port
keeps its own so that it imports nothing of the JAX package.

Telemetry closes the loop: the notebook controller decodes each gang's
telemetry annotation and feeds (gang key, model family, chip shape,
achieved MFU) here; the fleet scheduler consults the ledger when ranking
*idle* preemption/defrag candidates and when explaining placement
("this family historically achieves X on this shape").

Strictly advisory ordering: a persistently-low-MFU gang is *preferred
within the idle tier only*. It never outranks the existing protections —
workload-class tiers (serving is never a victim), busy-vs-idle, and
priority all sort first; tests/test_telemetry.py pins that down.

State is EWMA per (family, shape) and per gang, pure and clock-free —
the scheduler snapshots it into debug_info/explain like every other
policy structure.
"""

from __future__ import annotations

import os

LOW_MFU_ENV = "KFTPU_TELEMETRY_LOW_MFU"
DEFAULT_LOW_MFU = 0.25

MIN_SAMPLES_ENV = "KFTPU_TELEMETRY_MIN_SAMPLES"
DEFAULT_MIN_SAMPLES = 5

# EWMA weight for the newest sample: heavy enough to track a family
# switching phases, light enough that one bad window is not "persistent".
EWMA_ALPHA = 0.3


def low_mfu_threshold(environ=os.environ) -> float:
    raw = environ.get(LOW_MFU_ENV)
    try:
        return float(raw) if raw is not None else DEFAULT_LOW_MFU
    except ValueError:
        return DEFAULT_LOW_MFU


def min_samples(environ=os.environ) -> int:
    raw = environ.get(MIN_SAMPLES_ENV)
    try:
        value = int(raw) if raw is not None else DEFAULT_MIN_SAMPLES
    except ValueError:
        return DEFAULT_MIN_SAMPLES
    return max(1, value)


class _Ewma:
    __slots__ = ("value", "samples")

    def __init__(self):
        self.value: float | None = None
        self.samples = 0

    def update(self, sample: float) -> None:
        sample = max(0.0, min(1.0, float(sample)))
        if self.value is None:
            self.value = sample
        else:
            self.value = (1 - EWMA_ALPHA) * self.value + EWMA_ALPHA * sample
        self.samples += 1


class EfficiencyLedger:
    def __init__(self, *, low_mfu: float | None = None,
                 samples_needed: int | None = None, environ=os.environ):
        self.low_mfu = (low_mfu if low_mfu is not None
                        else low_mfu_threshold(environ))
        self.samples_needed = (samples_needed if samples_needed is not None
                               else min_samples(environ))
        self._families: dict[tuple[str, str], _Ewma] = {}
        self._gangs: dict[str, dict] = {}

    # ------------------------------------------------------------- write

    def note(self, key: str, family: str, shape: str, mfu) -> None:
        """Record one telemetry window for gang ``key`` (deduplicated by
        annotation seq at the caller). ``mfu`` may be None (unknown basis)
        — the sighting still registers family/shape for explain."""
        family = str(family or "unknown")
        shape = str(shape or "unknown")
        gang = self._gangs.setdefault(
            key, {"family": family, "shape": shape, "ewma": _Ewma()})
        gang["family"], gang["shape"] = family, shape
        if mfu is None:
            return
        gang["ewma"].update(mfu)
        self._families.setdefault((family, shape), _Ewma()).update(mfu)

    def forget(self, key: str) -> None:
        """Drop a gang's row (released/stopped). Family x shape history
        — the placement prior — survives the gang."""
        self._gangs.pop(key, None)

    # -------------------------------------------------------------- read

    def expected_mfu(self, family: str, shape: str) -> float | None:
        ewma = self._families.get((str(family), str(shape)))
        return ewma.value if ewma is not None else None

    def gang_mfu(self, key: str) -> float | None:
        gang = self._gangs.get(key)
        return gang["ewma"].value if gang is not None else None

    def persistently_low(self, key: str) -> bool:
        """True once a gang has enough windows AND its EWMA sits under
        the low-MFU threshold — the only signal the scheduler's idle-tier
        ranking consumes."""
        gang = self._gangs.get(key)
        if gang is None:
            return False
        ewma = gang["ewma"]
        return (ewma.samples >= self.samples_needed
                and ewma.value is not None
                and ewma.value < self.low_mfu)

    def explain(self, key: str) -> dict | None:
        """The 'this family historically achieves X on this shape' block
        for the scheduler's explain endpoint."""
        gang = self._gangs.get(key)
        if gang is None:
            return None
        family, shape = gang["family"], gang["shape"]
        expected = self.expected_mfu(family, shape)
        fam = self._families.get((family, shape))
        return {
            "family": family,
            "shape": shape,
            "gang_mfu": _round4(gang["ewma"].value),
            "gang_samples": gang["ewma"].samples,
            "expected_mfu": _round4(expected),
            "family_samples": fam.samples if fam is not None else 0,
            "persistently_low": self.persistently_low(key),
            "low_mfu_threshold": self.low_mfu,
        }

    def debug_info(self) -> dict:
        return {
            "low_mfu_threshold": self.low_mfu,
            "min_samples": self.samples_needed,
            "families": {
                f"{family}@{shape}": {
                    "mfu": _round4(ewma.value), "samples": ewma.samples,
                }
                for (family, shape), ewma in sorted(self._families.items())
            },
            "gangs": {
                key: {
                    "family": gang["family"],
                    "shape": gang["shape"],
                    "mfu": _round4(gang["ewma"].value),
                    "samples": gang["ewma"].samples,
                    "persistently_low": self.persistently_low(key),
                }
                for key, gang in sorted(self._gangs.items())
            },
        }


def _round4(value):
    return None if value is None else round(float(value), 4)
