"""Serving engine on PyTorch: paged KV-cache, prefill/decode lanes,
multi-model multiplexing.

The port of ``kubeflow_tpu/serving/engine.py``. Admission, the serve
loop, the lanes and the model registry's bookkeeping are copied from
it; the device half is torch. Each model's decode and prefill programs
are one ``score`` — ``burnin.forward`` plus the last position's argmax
under ``torch.inference_mode`` — run at two static shapes,
``[max_batch, seq_len]`` and ``[1, prefill_chunk]``. With
``attention="flash"`` every call runs the hand-written flash-attention
kernel once per layer. Each step syncs on the argmax's ``.cpu()``, as
the JAX engine syncs on ``np.asarray``, so step latencies include the
device time.

- **Paged KV-cache** (:mod:`kubeflow_tpu_torch.serving.kvcache`): a
  fixed block pool; a request is admitted to a lane only when its
  worst-case block need fits (:meth:`ServingEngine._admit_next` is the
  single admission choke point). Cache pressure surfaces as queue wait,
  never an OOM.
- **Decoupled prefill and decode lanes**: long prompts prefill in
  fixed-size chunks on their own lane, interleaved chunk-by-chunk with
  decode steps (``chunked_prefill=True``), so a long prompt never
  stalls decode head-of-line. ``chunked_prefill=False`` keeps the
  run-prefill-to-completion behavior as the measured baseline.
- **Multi-model multiplexing** (:class:`ModelRegistry`): models
  time-share the replica's card. Warm standbys keep weights in host
  memory and their fns built, so a model swap is a host-to-device copy
  plus a warm-up step — not an init. :meth:`ModelRegistry.activate` is
  the single swap door.
- **Park / warm restore** (the scale-to-zero substrate): ``park()``
  moves every resident model's weights to host memory; ``warm_restore()``
  is a device transfer. Requests may keep arriving while parked
  (:meth:`ServingEngine.submit`): they queue in the engine and complete
  after restore, their ``queue_wait`` spanning the park.

Weights live on the engine's device: the CUDA card unless the caller
passes ``device="cpu"`` (where attention takes the kernels' plain
versions). With no CUDA device and no device given, construction
raises.

**Sharded serving** (the JAX engine's ``use_mesh`` with more than one
device). JAX drives every device from one controller; the port runs one
process a card, joined by ``torch.distributed`` (``torchrun``, or
``parallel.launch.run_world``). With ``use_mesh`` set and a default
process group of more than one process, :class:`ModelRegistry` builds
``parallel.mesh.make_mesh()`` once: each process holds its shard of
every model (``burnin.shard_params``: heads of qkv and rows of attn_out,
columns of ff1 and rows of ff2 over "model"), and ``score`` runs
``burnin.forward`` with the mesh, so the logits, and the argmax, are
whole on every process. The tokens carry no sharding, so the "data"
replicas repeat the same batch, as in JAX; where ``n_heads`` does not
divide by the model axis, qkv and attn_out stay whole and only the FF
splits. Parked and demoted models keep each process's own shard in host
memory, and a warm swap or restore moves that shard back as it is: no
process ever holds a whole model on its host (the JAX engine's
``device_get`` gathers it on the controller's).

The host side runs in lockstep. Every rank constructs the engine and
makes the same lifecycle calls in the same order (``cold_start``,
``register_model``, ``use_model``, ``park``, ``warm_restore``,
``submit``, ``serve``); outside ``serve`` no decision reads the clock.
Inside ``serve``, rank 0 alone schedules: its clock, admission, lanes,
KV accounting and swaps. Before each device call it broadcasts one
control word on a gloo group of the engine's own (decode step, prefill
chunk, activate model, end), so the words travel on the host and add no
device sync; the other ranks follow the words with the same device calls
on their shards, in the same order, and return rank 0's
:class:`ServeReport`. The KV pool, lanes and queue that
:meth:`ServingEngine.debug_info` reports are rank 0's; a follower's stay
empty. Where rank 0 fails, it queues an abort word without waiting for
it and raises. A failure between device calls (admission, say) reaches
the followers as that word, and they raise. A failure inside a device
call leaves them in that call's model-axis collective, deaf to words:
they end only when the collective does, when rank 0's process is gone
(gloo: its closed connections) or at the group's timeout (NCCL). So a
failed rank's process must exit without shutting its groups down, which
would wait for the followers, as ``parallel.launch.run_world``'s
processes do (``os._exit``).
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.burnin import (
    BurninConfig,
    forward,
    init_params,
    map_params,
    shard_params,
)
from kubeflow_tpu_torch.parallel.mesh import make_mesh
from kubeflow_tpu_torch.runtime import slo
from kubeflow_tpu_torch.runtime.metrics import Registry, global_registry
from kubeflow_tpu_torch.runtime.tracing import span
from kubeflow_tpu_torch.serving.kvcache import (
    DEFAULT_BLOCK_SIZE,
    KVBlockPool,
    KVCacheError,
)

#: The model id requests carry when they don't ask for one — and the
#: model every engine registers at construction from its own ``cfg``.
DEFAULT_MODEL = "default"

# The control words rank 0 of a sharded engine sends before each device
# call of ``serve`` (op, argument): the followers make the same call.
_END, _DECODE, _PREFILL, _ACTIVATE, _ABORT = range(5)


@dataclass(frozen=True)
class EngineOptions:
    """Data-plane tuning knobs (the JAX engine's ``EngineOptions``)."""

    kv_blocks: int | None = None   # None → sized from max_batch × seq_len
    kv_block_size: int = DEFAULT_BLOCK_SIZE
    prefill_chunk: int = 32        # tokens per prefill chunk (static shape)
    chunked_prefill: bool = True   # False = run-to-completion baseline
    max_resident_models: int = 2   # models with weights on device at once


@dataclass(frozen=True)
class Request:
    """One inference request of the open-loop trace."""

    rid: int
    arrival: float             # seconds from trace start
    tokens_out: int = 8        # decode steps this request needs
    prompt_tokens: int = 0     # prompt length (0 = decode-only)
    model: str = DEFAULT_MODEL


@dataclass
class Completion:
    rid: int
    arrival: float
    started: float             # when it got a lane (prefill or decode)
    finished: float
    tokens: int
    prompt_tokens: int = 0
    model: str = DEFAULT_MODEL

    @property
    def latency(self) -> float:
        return self.finished - self.arrival

    @property
    def queue_wait(self) -> float:
        return self.started - self.arrival


@dataclass
class ServeReport:
    completions: list = field(default_factory=list)
    wall_sec: float = 0.0
    steps: int = 0
    batch_occupancy: float = 0.0   # mean filled decode slots per step
    prefill_chunks: int = 0
    prefill_tokens: int = 0
    model_swaps: int = 0
    kv_rejections: int = 0         # admissions deferred by cache pressure
    kv_peak_pressure: float = 0.0  # max used-fraction of the block pool

    @property
    def tokens(self) -> int:
        return sum(c.tokens for c in self.completions)

    @property
    def tokens_per_sec(self) -> float:
        return self.tokens / self.wall_sec if self.wall_sec > 0 else 0.0

    def latency_percentile(self, q: float) -> float:
        return self._percentile([c.latency for c in self.completions], q)

    def decode_latency_percentile(self, q: float) -> float:
        """Percentile over decode-only requests (no prompt) — the
        latency chunked prefill protects while long prompts land."""
        return self._percentile(
            [c.latency for c in self.completions if not c.prompt_tokens], q)

    def decode_service_percentile(self, q: float) -> float:
        """Like :meth:`decode_latency_percentile` but over service time
        (started → finished), excluding queue wait."""
        return self._percentile(
            [c.finished - c.started for c in self.completions
             if not c.prompt_tokens], q)

    @staticmethod
    def _percentile(lats: list, q: float) -> float:
        lats = sorted(lats)
        if not lats:
            return 0.0
        idx = min(len(lats) - 1, max(0, int(round(q * (len(lats) - 1)))))
        return lats[idx]


@dataclass
class _ModelEntry:
    """One registered model's standby state. Warmth is a spectrum:
    device-resident (serving) → host-resident with its fns built (warm
    standby: swap is a device transfer) → registered only (cold: swap is
    an init)."""

    model: str
    cfg: object
    device_params: object = None
    host_params: object = None
    decode_fn: object = None       # survives eviction AND park
    prefill_fn: object = None
    cold_init_sec: float | None = None
    warm_swap_sec: float | None = None
    last_used: int = 0

    @property
    def warm(self) -> bool:
        return self.host_params is not None and self.decode_fn is not None


class ModelRegistry:
    """Per-replica model registry with LRU warm standbys.

    At most ``max_resident`` models keep weights on the device; beyond
    that the least-recently-used model is demoted to host memory (it
    stays warm). All swaps go through :meth:`activate`. With ``use_mesh``
    in a world of more than one process, the weights on the device and
    on the host are this process's shards (see the module's docstring).
    """

    def __init__(self, *, max_batch: int, prefill_chunk: int = 32,
                 use_mesh: bool = True, max_resident: int = 2,
                 registry: Registry | None = None, device=None):
        self.max_batch = max_batch
        self.prefill_chunk = prefill_chunk
        self.use_mesh = use_mesh
        self.max_resident = max(1, max_resident)
        self.device = resolve_device(device)
        self._entries: dict = {}       # model -> _ModelEntry
        self._mesh = None
        if (use_mesh and dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            self._mesh = make_mesh(device_type=self.device.type)
        self._tick = 0
        self.swaps_cold = 0
        self.swaps_warm = 0
        reg = registry or global_registry
        self._c_swaps = reg.counter(
            "tpu_serving_model_swaps_total",
            "Model activations by kind (cold = init, warm = "
            "device transfer from a warm standby)", ["kind"])
        self._g_resident = reg.gauge(
            "tpu_serving_models_resident",
            "Models with weights currently on device")

    def register(self, model: str, cfg) -> None:
        """Declare a model. No weights move until :meth:`activate`."""
        if model not in self._entries:
            self._entries[model] = _ModelEntry(model=model, cfg=cfg)

    def entry(self, model: str):
        """The registered entry (standby state, swap timings) or None."""
        return self._entries.get(model)

    def __contains__(self, model: str) -> bool:
        return model in self._entries

    def models(self) -> list:
        return sorted(self._entries)

    @property
    def mesh(self):
        return self._mesh

    def _resident(self) -> list:
        return [e for e in self._entries.values()
                if e.device_params is not None]

    def _to_card(self, params):
        """``params`` (whole or this process's shards) on the engine's
        device, as they are."""
        return map_params(lambda t: t.to(self.device), params)

    def _to_device(self, params, cfg):
        """A model's global weights on the device: this process's shards
        of them on the mesh, else the whole tree."""
        if self._mesh is not None:
            params = shard_params(params, self._mesh, cfg)
        return self._to_card(params)

    @staticmethod
    def _to_host(params):
        # Each process keeps its own shards: nothing is gathered.
        return map_params(lambda t: t.to("cpu"), params)

    @staticmethod
    def _build_fns(cfg, mesh=None):
        def score(params, tokens):
            # One decode step: score the batch, return each sequence's
            # next-token argmax (the cheapest useful output — the bench
            # measures throughput, not sampling quality). On a mesh the
            # logits are whole on every process.
            with torch.inference_mode():
                logits = forward(params, tokens, cfg, mesh)
                return logits[:, -1, :].argmax(dim=-1)

        # Same program, two static shapes: [max_batch, seq_len] for
        # decode, [1, prefill_chunk] for a prefill chunk.
        return score, score

    def _warmup(self, entry) -> None:
        tokens = torch.zeros((self.max_batch, entry.cfg.seq_len),
                             dtype=torch.int64, device=self.device)
        entry.decode_fn(entry.device_params, tokens).cpu()
        chunk = torch.zeros((1, self.prefill_chunk), dtype=torch.int64,
                            device=self.device)
        entry.prefill_fn(entry.device_params, chunk).cpu()

    def _load_cold(self, entry, seed: int) -> None:
        params = init_params(entry.cfg, seed=seed, device=self.device)
        entry.device_params = self._to_device(params, entry.cfg)
        entry.decode_fn, entry.prefill_fn = self._build_fns(entry.cfg,
                                                            self._mesh)
        self._warmup(entry)

    def activate(self, model: str, *, seed: int = 0):
        """The single swap door: make ``model`` device-resident and
        return its entry. Cold (registered only) = init + warm-up; warm
        (standby) = device transfer + warm-up through the retained fns.
        Evicts the LRU resident past ``max_resident`` — demoted to a
        warm standby, not dropped."""
        entry = self._entries.get(model)
        if entry is None:
            raise KeyError(f"model {model!r} not registered")
        self._tick += 1
        entry.last_used = self._tick
        if entry.device_params is not None:
            return entry
        t0 = time.perf_counter()
        if entry.warm:
            # The host copy is already this process's shard: moved back
            # as it is, never cut again.
            entry.device_params = self._to_card(entry.host_params)
            entry.host_params = None
            self._warmup(entry)
            entry.warm_swap_sec = time.perf_counter() - t0
            self.swaps_warm += 1
            self._c_swaps.labels(kind="warm").inc()
        else:
            self._load_cold(entry, seed)
            entry.cold_init_sec = time.perf_counter() - t0
            self.swaps_cold += 1
            self._c_swaps.labels(kind="cold").inc()
        self._evict_over_budget(keep=model)
        self._g_resident.set(float(len(self._resident())))
        return entry

    def _evict_over_budget(self, *, keep: str) -> None:
        resident = self._resident()
        while len(resident) > self.max_resident:
            victim = min((e for e in resident if e.model != keep),
                         key=lambda e: e.last_used, default=None)
            if victim is None:
                return
            victim.host_params = self._to_host(victim.device_params)
            victim.device_params = None
            resident = self._resident()

    def park_all(self) -> None:
        """Scale-to-zero: every resident model's weights to host. The
        fns stay — restore is a device transfer."""
        for entry in self._resident():
            entry.host_params = self._to_host(entry.device_params)
            entry.device_params = None
        self._g_resident.set(0.0)

    def debug_info(self) -> dict:
        return {
            "maxResident": self.max_resident,
            "resident": sorted(e.model for e in self._resident()),
            "warmStandbys": sorted(e.model for e in self._entries.values()
                                   if e.warm),
            "registered": self.models(),
            "swaps": {"cold": self.swaps_cold, "warm": self.swaps_warm},
        }


@dataclass
class _Prefill:
    """The prefill lane's single in-flight prompt."""

    req: Request
    table: object
    arrival: float
    started: float
    done: int = 0
    ready: bool = False        # prefilled, waiting for a decode slot


class ServingEngine:
    """One replica's model server over the burn-in transformer (one rank
    of it when sharded: see the module's docstring)."""

    def __init__(self, cfg=None, *, max_batch: int = 8,
                 use_mesh: bool = True,
                 options: EngineOptions | None = None,
                 device=None):
        self.cfg = cfg or BurninConfig()
        self.max_batch = max_batch
        self.use_mesh = use_mesh
        self.options = options or EngineOptions()
        self._params = None          # active model's device weights
        self._host_params = None     # host weights while parked
        self._step_fn = None         # active model's decode fn
        self._prefill_fn = None      # active model's prefill fn
        self.parked = False
        self.cold_start_sec: float | None = None
        self.warm_restore_sec: float | None = None
        self.park_step = 0           # monotonically counts decode steps
        self._active_model = DEFAULT_MODEL
        self.models = ModelRegistry(
            max_batch=max_batch,
            prefill_chunk=self.options.prefill_chunk,
            use_mesh=use_mesh,
            max_resident=self.options.max_resident_models,
            device=device)
        self.device = self.models.device
        # The host group of the control words (a sharded engine only).
        self._ctl = (dist.new_group(backend="gloo")
                     if self.models.mesh is not None else None)
        self.models.register(DEFAULT_MODEL, self.cfg)
        self.kv = KVBlockPool(
            self.options.kv_blocks or self._default_kv_blocks(),
            block_size=self.options.kv_block_size)
        self._waiting: deque = deque()   # (Request, arrival_abs) admitted-not-yet
        self._prefill: _Prefill | None = None
        self._blocks_short = 0       # head-of-queue KV shortfall right now
        self._per_model_done: dict = {}
        self._born = time.perf_counter()

    def _default_kv_blocks(self) -> int:
        # Roomy default: every slot can hold a full-context request
        # twice over — the pool only bites when configured tighter.
        per_req = math.ceil(2 * self.cfg.seq_len / self.options.kv_block_size)
        return self.max_batch * per_req

    def now(self) -> float:
        """Seconds on the engine's own monotonic clock (born at
        construction — it keeps ticking across park/restore, which is
        what lets ``queue_wait`` span a park)."""
        return time.perf_counter() - self._born

    # ---- model registration / swap -------------------------------------------

    def register_model(self, model: str, cfg=None) -> None:
        """Declare a model this replica can serve (weights move only on
        first use / explicit warmup via the registry)."""
        self.models.register(model, cfg or self.cfg)

    def _activate_model(self, model: str, *, seed: int = 0) -> None:
        """The engine's single model-swap path: route through the
        warm-standby registry and mirror the active entry into
        ``_params`` / ``_step_fn`` / ``_prefill_fn``."""
        if model not in self.models:
            self.models.register(model, self.cfg)
        entry = self.models.activate(model, seed=seed)
        self._params = entry.device_params
        self._step_fn = entry.decode_fn
        self._prefill_fn = entry.prefill_fn
        self._active_model = model

    def use_model(self, model: str, *, seed: int = 0) -> None:
        """Public swap entry (gateway / bench / warmup): make ``model``
        the active model through the registry's single door."""
        if self.parked:
            raise RuntimeError("cannot swap models while parked")
        self._activate_model(model, seed=seed)

    # ---- lifecycle -----------------------------------------------------------

    def cold_start(self, seed: int = 0) -> float:
        """Full cold bring-up of the default model: init weights on the
        device, build the decode + prefill fns, run warm-up steps (the
        first of which builds the attention kernel when it is not built
        yet). Returns (and records) the wall seconds — the number warm
        restore and warm model swaps are measured against."""
        t0 = time.perf_counter()
        self._activate_model(DEFAULT_MODEL, seed=seed)
        self.parked = False
        self.cold_start_sec = time.perf_counter() - t0
        return self.cold_start_sec

    def park(self) -> dict:
        """Scale-to-zero park: every resident model's weights off the
        device into host memory, fns retained. Returns the checkpoint
        descriptor the controller's park protocol records (the path is
        symbolic). Requests may still :meth:`submit` while parked; they
        queue."""
        if self._params is None:
            raise RuntimeError("cannot park an engine that never started")
        self.models.park_all()
        entry = self.models.entry(self._active_model)
        self._host_params = entry.host_params
        self._params = None
        self.parked = True
        return {"path": f"mem://parked/{id(self):x}", "step": self.park_step}

    def warm_restore(self) -> float:
        """Scale-from-zero restore of a parked standby: copy the active
        model's host weights back to the device and warm up through the
        RETAINED fns. No init — the measured delta vs :meth:`cold_start`
        is the warm-standby win."""
        if not self.parked or self._host_params is None:
            raise RuntimeError("warm_restore() needs a parked engine")
        t0 = time.perf_counter()
        self._activate_model(self._active_model)
        self._host_params = None
        self.parked = False
        self.warm_restore_sec = time.perf_counter() - t0
        return self.warm_restore_sec

    # ---- submission ----------------------------------------------------------

    def submit(self, request: Request) -> None:
        """Enqueue a request on the engine's persistent queue — legal
        while parked (the queue accumulates, the controller restores,
        the next :meth:`serve` drains it; ``queue_wait`` spans the
        park)."""
        self._waiting.append((request, self.now()))

    # ---- serving loop --------------------------------------------------------

    def _admit_next(self, clock: float, slots: list, remaining: list,
                    started: list, arrivals: list) -> None:
        """The single admission choke point: strict-FIFO grants from
        the waiting queue into the prefill or decode lane, each gated
        by a worst-case KV block reservation (``KVBlockPool.admit``).
        Stops at the first request that can't be placed — cache
        pressure and lane pressure surface as queue wait."""
        while self._waiting:
            req, arrival_abs = self._waiting[0]
            model = getattr(req, "model", DEFAULT_MODEL)
            if model != self._active_model:
                # Drain-then-swap: let the current model's in-flight
                # work finish, then the registry makes the swap a
                # device transfer (warm) or an init (cold).
                busy = self._prefill is not None or any(
                    s is not None for s in slots)
                if busy:
                    break
                self._say_activate(model)
                self._activate_model(model)
            prompt = getattr(req, "prompt_tokens", 0)
            needs_prefill = prompt > 0 and self._prefill_fn is not None
            if needs_prefill and self._prefill is not None:
                break                      # prefill lane busy
            free = None
            if not needs_prefill:
                try:
                    free = slots.index(None)
                except ValueError:
                    break                  # decode lane full
            if self.kv.blocks_needed(prompt, req.tokens_out) \
                    > self.kv.total_blocks:
                raise KVCacheError(
                    f"request {req.rid} can never fit: needs "
                    f"{self.kv.blocks_needed(prompt, req.tokens_out)} "
                    f"blocks, pool holds {self.kv.total_blocks}")
            table = self.kv.admit(req.rid, prompt, req.tokens_out)
            if table is None:
                # Cache pressure: leave it queued (backpressure, never
                # OOM) and remember the shortfall for status surfaces.
                self._blocks_short = self.kv.blocks_short(
                    prompt, req.tokens_out)
                break
            self._blocks_short = 0
            self._waiting.popleft()
            if needs_prefill:
                self._prefill = _Prefill(req=req, table=table,
                                         arrival=arrival_abs, started=clock)
            else:
                slots[free] = (req, table)
                remaining[free] = req.tokens_out
                started[free] = clock
                arrivals[free] = arrival_abs

    # ---- lockstep of a sharded engine ---------------------------------------

    def _follows(self) -> bool:
        """True on a sharded engine's ranks other than 0."""
        return self._ctl is not None and dist.get_rank() != 0

    def _say(self, op: int, arg: int = 0, *, wait: bool = True) -> None:
        """Rank 0: send the followers one control word (a no-op unless
        sharded); ``wait=False`` leaves it queued without waiting for a
        follower to take it."""
        if self._ctl is not None:
            work = dist.broadcast(torch.tensor([op, arg]), src=0,
                                  group=self._ctl, async_op=True)
            if wait:
                work.wait()

    def _hear(self) -> tuple:
        word = torch.empty(2, dtype=torch.int64)
        dist.broadcast(word, src=0, group=self._ctl)
        return int(word[0]), int(word[1])

    def _say_activate(self, model: str) -> None:
        """Rank 0: tell the followers to activate ``model``: its index in
        ``models()``, or -1 and the name where it is not registered yet."""
        if self._ctl is None:
            return
        if model in self.models:
            self._say(_ACTIVATE, self.models.models().index(model))
        else:
            self._say(_ACTIVATE, -1)
            dist.broadcast_object_list([model], src=0, group=self._ctl)

    def _follow(self) -> ServeReport:
        """A follower's ``serve``: the device call of each of rank 0's
        control words, in order, on this rank's shards, until the end;
        then rank 0's report. The requests are rank 0's to schedule."""
        self._waiting.clear()
        tokens, chunk_buf = self._buffers()
        while True:
            op, arg = self._hear()
            if op == _END:
                break
            if op == _DECODE:
                self._step_fn(self._params, tokens).cpu()
                self.park_step += 1
            elif op == _PREFILL:
                self._prefill_fn(self._params, chunk_buf).cpu()
            elif op == _ACTIVATE:
                name = [self.models.models()[arg] if arg >= 0 else None]
                if arg < 0:
                    dist.broadcast_object_list(name, src=0, group=self._ctl)
                self._activate_model(name[0])
            else:
                raise RuntimeError(
                    "rank 0 of the sharded engine failed while serving "
                    "(its own traceback has the cause)")
        shared = [None, None]
        dist.broadcast_object_list(shared, src=0, group=self._ctl)
        report, self._per_model_done = shared
        return report

    def _buffers(self) -> tuple:
        # The same zero token buffers the JAX engine feeds: the loop
        # measures serving throughput, and the argmax is discarded.
        return (torch.zeros((self.max_batch, self.cfg.seq_len),
                            dtype=torch.int64, device=self.device),
                torch.zeros((1, self.options.prefill_chunk),
                            dtype=torch.int64, device=self.device))

    def serve(self, requests: list, *, time_scale: float = 1.0) -> ServeReport:
        """Run one open-loop trace to completion with continuous
        batching. ``requests`` arrive at ``arrival * time_scale`` on
        the engine's own clock whether or not lanes are free (open loop
        — the backlog shows up as queue wait in the latency
        percentiles). The trace clock never waits for the model: if the
        model is the bottleneck, arrivals pile up, exactly like
        production. Requests :meth:`submit`-ted earlier (including
        while parked) drain first.

        Sharded, every rank calls it with the same requests; rank 0
        schedules them and every rank returns rank 0's report."""
        if self._params is None or self._step_fn is None:
            raise RuntimeError("engine not started (cold_start/warm_restore)")
        if self._follows():
            return self._follow()
        if self._ctl is None:
            return self._serve(requests, time_scale)
        try:
            report = self._serve(requests, time_scale)
        except BaseException:
            # Not waited for: where rank 0 failed inside a device call,
            # the followers are in that call's collective, not listening.
            self._say(_ABORT, wait=False)
            raise
        self._say(_END)
        dist.broadcast_object_list([report, dict(self._per_model_done)],
                                   src=0, group=self._ctl)
        return report

    def _serve(self, requests: list, time_scale: float) -> ServeReport:
        """The serve loop (rank 0's, when sharded)."""
        opts = self.options
        t0_abs = self.now()
        pending = [(r, t0_abs + r.arrival * time_scale)
                   for r in sorted(requests, key=lambda r: (r.arrival, r.rid))]
        slots: list = [None] * self.max_batch      # (Request, BlockTable)
        remaining = [0] * self.max_batch
        started = [0.0] * self.max_batch
        arrivals = [0.0] * self.max_batch
        tokens, chunk_buf = self._buffers()
        report = ServeReport()
        occupancy = 0
        kv_rej0 = self.kv.rejections
        swaps0 = self.models.swaps_cold + self.models.swaps_warm

        def finish(i: int, clock: float) -> None:
            req, table = slots[i]
            done = Completion(
                rid=req.rid, arrival=arrivals[i], started=started[i],
                finished=clock, tokens=req.tokens_out,
                prompt_tokens=getattr(req, "prompt_tokens", 0),
                model=getattr(req, "model", DEFAULT_MODEL))
            report.completions.append(done)
            self._per_model_done[done.model] = \
                self._per_model_done.get(done.model, 0) + 1
            # Serving-latency SLI: arrival → completion, queue wait
            # included — the p99 promise covers the backlog, not just
            # compute.
            slo.observe("serving_latency", done.latency)
            self.kv.release(req.rid)
            slots[i] = None

        with span("serve", requests=len(pending), max_batch=self.max_batch):
            while (pending or self._waiting or self._prefill is not None
                   or any(s is not None for s in slots)):
                clock = self.now()
                while pending and pending[0][1] <= clock:
                    self._waiting.append(pending.pop(0))
                self._admit_next(clock, slots, remaining, started, arrivals)

                # Prefill lane: one fixed-shape chunk per iteration.
                pf = self._prefill
                if pf is not None and not pf.ready:
                    n = min(opts.prefill_chunk,
                            pf.req.prompt_tokens - pf.done)
                    self._say(_PREFILL)
                    self._prefill_fn(self._params, chunk_buf).cpu()
                    pf.table.append(n)
                    pf.done += n
                    report.prefill_chunks += 1
                    report.prefill_tokens += n
                    if pf.done >= pf.req.prompt_tokens:
                        pf.ready = True
                if pf is not None and pf.ready:
                    # Hand the prefilled prompt to the decode lane the
                    # moment a slot frees (the lane handoff).
                    try:
                        free = slots.index(None)
                    except ValueError:
                        free = None
                    if free is not None:
                        slots[free] = (pf.req, pf.table)
                        remaining[free] = pf.req.tokens_out
                        started[free] = pf.started
                        arrivals[free] = pf.arrival
                        self._prefill = None
                if (self._prefill is not None and not opts.chunked_prefill
                        and not self._prefill.ready):
                    # Head-of-line baseline: an in-flight prefill runs
                    # to completion before any decode step.
                    continue

                active = [i for i, s in enumerate(slots) if s is not None]
                if not active:
                    if self._prefill is not None:
                        continue           # prefill still progressing
                    # Idle until the next arrival (scaled trace time).
                    if pending and not self._waiting:
                        wait = pending[0][1] - self.now()
                        if wait > 0:
                            time.sleep(min(wait, 0.05))
                    continue
                # One decode step for the whole batch (static shape).
                self._say(_DECODE)
                self._step_fn(self._params, tokens).cpu()
                self.park_step += 1
                report.steps += 1
                occupancy += len(active)
                report.kv_peak_pressure = max(report.kv_peak_pressure,
                                              self.kv.pressure)
                clock = self.now()
                for i in active:
                    remaining[i] -= 1
                    slots[i][1].append(1)  # one decode token of KV
                    if remaining[i] <= 0:
                        finish(i, clock)
        report.wall_sec = self.now() - t0_abs
        report.batch_occupancy = (occupancy / report.steps
                                  if report.steps else 0.0)
        report.kv_rejections = self.kv.rejections - kv_rej0
        report.model_swaps = (self.models.swaps_cold
                              + self.models.swaps_warm) - swaps0
        return report

    # ---- observability -------------------------------------------------------

    def debug_info(self) -> dict:
        """The engine's ``/debug/`` payload: KV pressure, lane state,
        model registry — what an operator checks when p99 climbs."""
        pf = self._prefill
        return {
            "parked": self.parked,
            "activeModel": self._active_model,
            "queued": len(self._waiting),
            "blocksShort": self._blocks_short,
            "kv": self.kv.debug_info(),
            "lanes": {
                "decodeSlots": self.max_batch,
                "prefill": None if pf is None else {
                    "rid": pf.req.rid, "done": pf.done,
                    "promptTokens": pf.req.prompt_tokens,
                    "ready": pf.ready,
                },
                "chunkedPrefill": self.options.chunked_prefill,
                "prefillChunk": self.options.prefill_chunk,
            },
            "perModelCompleted": dict(self._per_model_done),
            "models": self.models.debug_info(),
        }
