"""The port's persistent kernel cache and warm-pool cache seeding: the
counterpart of ``kubeflow_tpu/utils/compilecache.py``.

The port compiles nothing through XLA, Inductor or Triton: its one
compile is ``nvcc`` in ``ops/_build.py``, which writes one shared library
a CUDA source into its library directory under a name keyed by the
source, headers, flags and toolkit. That directory *is* the compile
cache: a library already there is loaded, not built. This module is the
one place that knows where it lives:

- **Notebook images**: ``$KFTPU_COMPILE_CACHE_DIR`` (on the workspace
  PVC, so the cache survives stop/start cycles). Unset, the cache is
  ``_build``'s own ``<repo>/build/kubeflow_tpu_torch/``.
- **Warm-pool pods**: the SDK's warm-idle loop calls
  :func:`enable_persistent_cache` and :func:`seed_cache` before it builds,
  copying the libraries in ``$KFTPU_COMPILE_CACHE_SEED_DIR`` (baked into
  the image or mounted from a shared volume) into the live cache dir: a
  claimed pod's first launch then loads a library instead of paying
  ``nvcc``.

An entry is a library (``*.so``); a ``.tmp`` file that a build or a seed
is still writing is not one. Failure semantics as the reference's: an
unusable cache dir is logged once, counted in
``compile_cache_setup_failures_total`` and reported by
:func:`cache_dir_ready`, and ``_build`` stays where it was. Cache
effectiveness is counted by :func:`note_compile` (an unchanged entry
count across a build is a hit).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import shutil

from kubeflow_tpu_torch.ops import _build

log = logging.getLogger(__name__)

ENV_VAR = "KFTPU_COMPILE_CACHE_DIR"
SEED_DIR_ENV = "KFTPU_COMPILE_CACHE_SEED_DIR"

# Optional manifest file inside a seed dir: a JSON list of entry file
# names to copy (a subset pin). Absent → every library seeds.
SEED_MANIFEST = "manifest.json"

LIBRARY_SUFFIX = ".so"

# Module-level counters (the in-pod path must not require the metrics
# registry); mirrored into Prometheus on the port's global registry.
_counters = {"setup_failures": 0, "hits": 0, "misses": 0, "seeded": 0}
_setup_failed_dirs: set[str] = set()


def _prom_inc(name: str, help_: str) -> None:
    """Best-effort Prometheus mirror: the warm-idle loop and probes run
    in pods that may not serve /metrics; the module counters stay the
    source of truth either way."""
    try:
        from kubeflow_tpu_torch.runtime.metrics import global_registry

        global_registry.counter(name, help_).inc()
    except Exception:  # kftpu: ignore[exception-swallow] metrics are a mirror; the module counter already recorded the event
        pass


def setup_failures_total() -> int:
    return _counters["setup_failures"]


def cache_stats() -> dict:
    """Snapshot of the module counters."""
    return dict(_counters)


def default_cache_dir() -> str:
    return os.path.expanduser(os.environ.get(ENV_VAR)
                              or str(_build.DEFAULT_BUILD_DIR))


def _is_library(entry: os.DirEntry) -> bool:
    return entry.is_file() and entry.name.endswith(LIBRARY_SUFFIX)


def cache_entries(cache_dir: str | None = None) -> int:
    """Number of cached libraries (0 for a missing/empty dir)."""
    d = cache_dir or default_cache_dir()
    try:
        return sum(1 for e in os.scandir(d) if _is_library(e))
    except OSError:
        return 0


def cache_dir_ready(cache_dir: str | None = None) -> bool:
    """Is the cache directory usable (exists and writable)? The flag the
    warm-pool seeder and readiness probes assert on."""
    d = os.path.abspath(cache_dir or default_cache_dir())
    return os.path.isdir(d) and os.access(d, os.W_OK)


def enable_persistent_cache(cache_dir: str | None = None) -> str:
    """Point ``_build``'s library directory at ``cache_dir`` (default
    :func:`default_cache_dir`), creating it. Idempotent. Returns the
    resolved directory.

    A directory that cannot be created or written (read-only image fs,
    broken PVC mount) is logged once, counted in
    ``compile_cache_setup_failures_total``, and ``_build`` is left where
    it was: kernels then build there rather than fail against a dead dir.
    :func:`cache_dir_ready` reports the outcome."""
    d = os.path.abspath(cache_dir or default_cache_dir())
    try:
        os.makedirs(d, exist_ok=True)
        if not os.access(d, os.W_OK):
            raise OSError(f"{d} is not writable")
    except OSError as e:
        _counters["setup_failures"] += 1
        _prom_inc("compile_cache_setup_failures_total",
                  "Compile-cache directory setup failures")
        if d not in _setup_failed_dirs:
            _setup_failed_dirs.add(d)
            log.error(
                "kernel cache dir %s unusable (%s): kernels build in %s "
                "instead until the mount/permissions are fixed", d, e,
                _build.BUILD_DIR)
        return d
    _build.set_library_dir(d)
    return d


def seed_cache(seed_dir: str | None = None,
               cache_dir: str | None = None) -> dict:
    """Copy every library in ``seed_dir`` (default
    ``$KFTPU_COMPILE_CACHE_SEED_DIR``) into the live cache dir, skipping
    those already present. A ``manifest.json`` (JSON list of file names)
    inside the seed dir pins the subset. Each copy lands through a
    temporary file and a rename, so a concurrent loader never opens half
    a library.

    Returns ``{"seeded": n, "skipped": n, "ready": bool}``; a missing or
    unconfigured seed dir is a clean no-op (``seeded=0``), a broken cache
    dir is reported by ``ready=False``."""
    src = seed_dir or os.environ.get(SEED_DIR_ENV)
    dst = os.path.abspath(cache_dir or default_cache_dir())
    out = {"seeded": 0, "skipped": 0, "ready": cache_dir_ready(dst)}
    if not src or not os.path.isdir(src) or not out["ready"]:
        return out
    names = None
    manifest = os.path.join(src, SEED_MANIFEST)
    if os.path.isfile(manifest):
        try:
            with open(manifest, encoding="utf-8") as fh:
                listed = json.load(fh)
            if isinstance(listed, list):
                names = {str(n) for n in listed}
        except (OSError, ValueError):
            log.warning("unreadable seed manifest %s; seeding every "
                        "library in %s", manifest, src)
    try:
        entries = [e for e in os.scandir(src)
                   if _is_library(e) and (names is None or e.name in names)]
    except OSError:
        return out
    for entry in entries:
        target = os.path.join(dst, entry.name)
        if os.path.exists(target):
            out["skipped"] += 1
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        try:
            shutil.copyfile(entry.path, tmp)
            os.replace(tmp, target)
        except OSError:
            with contextlib.suppress(OSError):
                os.remove(tmp)
            out["ready"] = cache_dir_ready(dst)
            continue
        out["seeded"] += 1
    _counters["seeded"] += out["seeded"]
    return out


def note_compile(entries_before: int, entries_after: int) -> str:
    """Classify one build against the cache and count it: an unchanged
    entry count means every library came FROM the cache (hit); a grown
    count means ``nvcc`` compiled and wrote one (miss, warm for next
    time)."""
    if entries_after <= entries_before:
        _counters["hits"] += 1
        _prom_inc("compile_cache_hits_total",
                  "Builds served from the persistent cache")
        return "hit"
    _counters["misses"] += 1
    _prom_inc("compile_cache_misses_total",
              "Builds that missed the persistent cache")
    return "miss"
