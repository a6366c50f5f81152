"""Paged KV-cache: a fixed pool of cache blocks behind admission.

A copy of ``kubeflow_tpu/serving/kvcache.py`` (the pool is pure Python
accounting; the port keeps its own copy so that it imports nothing of
the JAX package).

The serving engine's memory plane. HBM for attention
key/value state is the scarce resource of a serving replica; v1 sized
it implicitly (max_batch × seq_len, allocated up front) which makes
"can this request fit?" undecidable and OOM the failure mode. v2 makes
it a first-class allocator, the vLLM paged-attention idea adapted
TPU-first:

- The cache is a **fixed pool of fixed-size blocks** (``block_size``
  tokens of K/V per block). Pool capacity is chosen once at engine
  bring-up, so device allocation stays static — one shape, one compile.
- A request owns a **block table** (its ordered block list). Tables are
  granted **all-or-nothing at admission** for the request's *worst
  case* need (prompt + max decode tokens). A request that fits never
  OOMs mid-decode; a request that doesn't fit waits in the queue —
  **backpressure is queue wait, never an allocator failure**.
- The pool never oversells: blocks move between exactly one free list
  and exactly one owner table. :meth:`assert_consistent` re-derives the
  invariant from scratch and any breach increments :attr:`violations`
  (the bench's seeded fault storm gates on this staying 0).

Observability: ``tpu_serving_kv_blocks_used`` / ``_total`` gauges and
:meth:`debug_info` (surfaced under ``/debug/`` by the serving engine's
debug payload).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from kubeflow_tpu_torch.runtime.metrics import Registry, global_registry

#: Tokens of K/V state per cache block. 16 is the paged-attention
#: sweet spot: small enough that short prompts don't strand capacity,
#: large enough that block tables stay short.
DEFAULT_BLOCK_SIZE = 16


class KVCacheError(RuntimeError):
    """A caller broke the allocator protocol (double admit, append past
    the reserved worst case). Raised, not swallowed — these are bugs in
    the engine, not load conditions."""


@dataclass
class BlockTable:
    """One admitted request's view of the cache: its ordered block list
    plus the token count appended so far. The table's capacity is the
    worst case reserved at admission — appends can never outgrow it."""

    rid: int
    blocks: list = field(default_factory=list)
    block_size: int = DEFAULT_BLOCK_SIZE
    tokens: int = 0                  # tokens written so far

    @property
    def capacity_tokens(self) -> int:
        return len(self.blocks) * self.block_size

    def append(self, n_tokens: int) -> None:
        """Record ``n_tokens`` of K/V written into this table (a prefill
        chunk or one decode step). The reservation already covers the
        worst case, so overflow is a protocol bug, not cache pressure."""
        if self.tokens + n_tokens > self.capacity_tokens:
            raise KVCacheError(
                f"request {self.rid}: append({n_tokens}) past reserved "
                f"capacity {self.capacity_tokens} (have {self.tokens})")
        self.tokens += n_tokens


class KVBlockPool:
    """The fixed block pool: allocator, per-request tables, gauges.

    Single-threaded by design — the engine's serve loop is the only
    caller, matching the one-engine-per-replica model. All admission
    goes through :meth:`admit` (the ci/analysis serving contract pins
    the engine's lane grants to this choke point).
    """

    def __init__(self, total_blocks: int, *,
                 block_size: int = DEFAULT_BLOCK_SIZE,
                 registry: Registry | None = None):
        if total_blocks <= 0:
            raise ValueError(f"total_blocks must be positive: {total_blocks}")
        if block_size <= 0:
            raise ValueError(f"block_size must be positive: {block_size}")
        self.total_blocks = total_blocks
        self.block_size = block_size
        self._free: list = list(range(total_blocks - 1, -1, -1))
        self._tables: dict = {}      # rid -> BlockTable
        self.rejections = 0          # admissions refused (cache pressure)
        self.violations = 0          # accounting invariant breaches
        reg = registry or global_registry
        self._g_used = reg.gauge(
            "tpu_serving_kv_blocks_used",
            "KV-cache blocks currently owned by admitted requests")
        self._g_total = reg.gauge(
            "tpu_serving_kv_blocks_total",
            "KV-cache block pool capacity")
        self._g_total.set(float(total_blocks))
        self._g_used.set(0.0)

    # ---- sizing --------------------------------------------------------------

    def blocks_needed(self, prompt_tokens: int, tokens_out: int) -> int:
        """Worst-case block need: the whole prompt plus every decode
        token the request may emit, rounded up to whole blocks."""
        tokens = max(0, prompt_tokens) + max(0, tokens_out)
        return max(1, math.ceil(tokens / self.block_size))

    @property
    def used_blocks(self) -> int:
        return self.total_blocks - len(self._free)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def pressure(self) -> float:
        """Used fraction of the pool, 0..1."""
        return self.used_blocks / self.total_blocks

    def blocks_short(self, prompt_tokens: int, tokens_out: int) -> int:
        """How many blocks a request is short of admission right now
        (0 = it would fit). This is the k in the JWA's "Queued behind
        KV-cache pressure (k blocks short)" message."""
        return max(0, self.blocks_needed(prompt_tokens, tokens_out)
                   - len(self._free))

    # ---- allocate / free -----------------------------------------------------

    def admit(self, rid: int, prompt_tokens: int, tokens_out: int):
        """All-or-nothing worst-case reservation. Returns the request's
        :class:`BlockTable`, or ``None`` under cache pressure (the
        caller leaves the request queued — backpressure, never OOM)."""
        if rid in self._tables:
            raise KVCacheError(f"request {rid} admitted twice")
        need = self.blocks_needed(prompt_tokens, tokens_out)
        if need > len(self._free):
            self.rejections += 1
            return None
        blocks = [self._free.pop() for _ in range(need)]
        table = BlockTable(rid=rid, blocks=blocks, block_size=self.block_size)
        self._tables[rid] = table
        self._g_used.set(float(self.used_blocks))
        return table

    def release(self, rid: int) -> int:
        """Return a finished (or aborted) request's blocks to the free
        list. Idempotent: releasing an unknown/already-released rid is a
        no-op returning 0, so completion and abort paths can't
        double-free a block between them."""
        table = self._tables.pop(rid, None)
        if table is None:
            return 0
        freed = 0
        free_set = set(self._free)
        for b in table.blocks:
            if b in free_set or b < 0 or b >= self.total_blocks:
                # A block that is already free (or out of range) means
                # the accounting was broken before this call — count it
                # rather than corrupt the free list further.
                self.violations += 1
                continue
            self._free.append(b)
            freed += 1
        table.blocks = []
        self._g_used.set(float(self.used_blocks))
        return freed

    # ---- invariants / debug --------------------------------------------------

    def assert_consistent(self) -> None:
        """Re-derive the no-oversell invariant from scratch: every block
        is on the free list or in exactly one table, never both, and the
        counts add up. Breaches increment :attr:`violations` and raise."""
        problems = []
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            problems.append("duplicate blocks on the free list")
        owned: dict = {}
        for rid, table in self._tables.items():
            for b in table.blocks:
                if b in owned:
                    problems.append(
                        f"block {b} owned by both {owned[b]} and {rid}")
                owned[b] = rid
                if b in free_set:
                    problems.append(f"block {b} owned by {rid} AND free")
        if len(owned) + len(free_set) != self.total_blocks:
            problems.append(
                f"{len(owned)} owned + {len(free_set)} free != "
                f"{self.total_blocks} total")
        if problems:
            self.violations += len(problems)
            raise KVCacheError("; ".join(problems))

    def debug_info(self) -> dict:
        """Pressure snapshot for the engine's ``/debug/`` payload."""
        return {
            "blockSize": self.block_size,
            "totalBlocks": self.total_blocks,
            "usedBlocks": self.used_blocks,
            "freeBlocks": self.free_blocks,
            "pressure": round(self.pressure, 4),
            "admitted": len(self._tables),
            "rejections": self.rejections,
            "violations": self.violations,
        }
