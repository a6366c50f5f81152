"""Registered named sections around the parallel stack's collectives,
spans inside the train step, and serialize mode.

The port of ``kubeflow_tpu/telemetry/sections.py``. Every collective in
``parallel/ring.py``, ``parallel/ulysses.py``, ``parallel/moe.py`` and
``parallel/pipeline.py`` goes through :func:`collective`, which rejects a
name that is not registered in ``SECTION_SPECS`` and runs the op inside
``torch.profiler.record_function("kftpu." + name)``, so a profiler trace
books communication time under the same names as the JAX package's
traces.

:func:`span` is the same for the rest of the train step: the model's
sections (``models/burnin.py``), the trainer's accumulation, clip and
update (``models/trainer.py``), the input pipeline's wait and copy
(``data.py``) and the MoE layer's stages (``parallel/moe.py``), each name
registered in ``SPAN_SPECS``.

A span books the backward of its ops too. While a profiler collects, each
span keeps the interval of autograd sequence numbers its ops took (the
numbers of the autograd nodes they made, on the thread that made them);
:func:`tag_backward`, which ``models/tree.value_and_grad`` calls before it
takes the gradient, walks the graph behind the loss, gives each node made since the last walk the
innermost span whose interval holds its number, and hooks the node where
that span changes. Autograd runs one device's nodes in falling number
(highest first among the ready ones, and a node's inputs have lower
numbers), so as it runs a hooked node (on its own thread, for the card),
the hook closes the thread's open backward range and opens
``kftpu.<span>`` in its place; the range open at the end of the backward
closes with it (``queue_callback``). So a
backward kernel, and the gradient sums autograd launches after a node,
lie in the range of the span whose forward op made the node, on the
thread that launched them. A node made outside every span closes the open
range. The hooks return nothing, so no gradient changes.

Both enter ``record_function`` only while a torch profiler collects
(``torch.autograd.profiler._is_profiler_enabled``, set for every session
of the process, whichever thread started it and whichever threads it
records: the profiler server's every-thread sessions too; torch's
``_profiler_enabled()`` reads false there). Otherwise they return one
shared null context: an unguarded ``record_function`` costs ~12 us a range
on the host even with no profiler, a guarded span ~0.6 us (a CPU, torch
2.13). There is no switch: spans are on exactly when a profiler runs.

*Serialize mode* (:func:`set_serialize_collectives`) fences every
registered collective from compute, for the overlap A/B
(``telemetry.overlap_fraction`` of the same step run both ways): before
the op, the current CUDA stream's queued work finishes; after it, the
collective itself finishes. Both waits are
``torch.cuda.current_stream().synchronize()`` once the process has
started CUDA; on the CPU, where an op runs to its end before it returns,
there is nothing to wait for. It is the eager counterpart of the JAX
module's ``optimization_barrier`` fences. The backward of every ported
collective calls :func:`collective` again (``ring.shift`` backwards, the
pipeline's stage hop), so both directions are fenced with no custom VJP.
Unlike the JAX module's trace-time flag, the mode takes effect per call:
flipping it changes the next collective a step issues, with no rebuild.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import itertools
import threading

import torch
import torch.autograd.profiler as _autograd_profiler

# (name, module, description): the JAX package's names for these sections.
SECTION_SPECS = (
    ("ring_kv_hop", "kubeflow_tpu_torch/parallel/ring",
     "K/V block send to the next ring neighbor (xla block impl)"),
    ("ring_flash_kv_hop", "kubeflow_tpu_torch/parallel/ring",
     "K/V block send in the flash-kernel ring forward"),
    ("ring_flash_grad_hop", "kubeflow_tpu_torch/parallel/ring",
     "K/V + dK/dV accumulator send in the flash ring backward"),
    ("ulysses_all_to_all", "kubeflow_tpu_torch/parallel/ulysses",
     "heads<->sequence all_to_all (both directions of the exchange)"),
    ("moe_dispatch_all_to_all", "kubeflow_tpu_torch/parallel/moe",
     "token-slot all_to_all scattering tokens to their experts"),
    ("moe_combine_all_to_all", "kubeflow_tpu_torch/parallel/moe",
     "expert-output all_to_all returning tokens to their home shard"),
    ("pipeline_stage_hop", "kubeflow_tpu_torch/parallel/pipeline",
     "activation send to the next pipeline stage (and its cotangent "
     "back)"),
)

SECTION_NAMES = frozenset(spec[0] for spec in SECTION_SPECS)

# (name, module, description): the train step's spans, nested by the code.
SPAN_SPECS = (
    ("train_step", "kubeflow_tpu_torch/models/trainer, kubeflow_tpu_torch/models/burnin",
     "one train step (the trainer's carries the step count as its args)"),
    ("embed", "kubeflow_tpu_torch/models/burnin",
     "token embedding gather and the position add"),
    ("norm", "kubeflow_tpu_torch/models/burnin",
     "one RMSNorm (ln1, ln2, out_norm), in f32"),
    ("attention_layer", "kubeflow_tpu_torch/models/burnin",
     "x + attention(norm(x)): qkv and out GEMMs, the weight casts, flash "
     "or dense attention, the model-axis sum, the residual add"),
    ("mlp_layer", "kubeflow_tpu_torch/models/burnin",
     "x + ff2(gelu(ff1(norm(x)))): the GEMMs, casts, GELU, model-axis sum "
     "and residual add"),
    ("head", "kubeflow_tpu_torch/models/burnin",
     "the tied head's product and its f32 cast"),
    ("loss", "kubeflow_tpu_torch/models/burnin",
     "next-token cross entropy"),
    ("accumulate", "kubeflow_tpu_torch/models/trainer",
     "a microbatch's gradients scaled and summed, and its loss"),
    ("update", "kubeflow_tpu_torch/models/trainer, kubeflow_tpu_torch/models/burnin",
     "the optimizer's update (AdamW or SGD; the trainer's holds the clip)"),
    ("clip", "kubeflow_tpu_torch/models/trainer",
     "the global-norm clip of the gradients"),
    ("data_wait", "kubeflow_tpu_torch/data",
     "the consumer's wait on the prefetch queue"),
    ("data_stage", "kubeflow_tpu_torch/data",
     "a leaf's pinned-buffer wait, host copy and non-blocking copy to the "
     "card"),
    ("moe_router", "kubeflow_tpu_torch/parallel/moe",
     "router logits, top-k seats and the load-balancing loss"),
    ("moe_seat_table", "kubeflow_tpu_torch/parallel/moe",
     "the seat -> token table and the gates per seat"),
    ("moe_dispatch", "kubeflow_tpu_torch/parallel/moe",
     "the slot rows gathered from the tokens"),
    ("moe_expert_ffn", "kubeflow_tpu_torch/parallel/moe",
     "the experts' batched GEMMs and GELU"),
    ("moe_combine", "kubeflow_tpu_torch/parallel/moe",
     "each token's slot rows gathered back, scaled by its gates"),
)

SPAN_NAMES = frozenset(spec[0] for spec in SPAN_SPECS)

# What a span or section is while no profiler collects.
_OFF = contextlib.nullcontext()

_serialize = False


def set_serialize_collectives(on: bool) -> None:
    """Fence every registered collective from compute (see the module's
    docstring); takes effect at the next collective issued."""
    global _serialize
    _serialize = bool(on)


def serialize_collectives() -> bool:
    return _serialize


def _fence() -> None:
    """Wait for the current CUDA stream's queued work where this process
    has started CUDA; nothing on the CPU."""
    if torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


def _range(name: str, args=None):
    """``record_function("kftpu." + name)`` (``args`` as its string)
    while a torch profiler collects, else the shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(
        "kftpu." + name, None if args is None else str(args))


# The next autograd sequence number of the calling thread (torch's
# ``at::sequence_number::peek``).
_next_seq = torch._C._autograd._get_sequence_nr
# Spans recorded before the intervals are dropped unused (no backward
# walked them).
_MAX_CLOSED = 1 << 16


class _Marks(threading.local):
    """One thread's span intervals: ``[start, end, name, order, parent]``,
    ``end`` None while the span is open."""

    def __init__(self):
        self.open: list = []
        self.closed: list = []
        self.walked = 0          # nodes numbered below were walked
        self.order = itertools.count()


_marks = _Marks()


class _Span:
    """A span while a profiler collects: its ``record_function`` range and
    its interval of autograd sequence numbers."""

    __slots__ = ("name", "args", "_range", "_mark")

    def __init__(self, name: str, args):
        self.name, self.args = name, args

    def __enter__(self):
        self._range = _range(self.name, self.args)
        self._range.__enter__()
        m = _marks
        self._mark = [_next_seq(), None, self.name, next(m.order),
                      m.open[-1] if m.open else None]
        m.open.append(self._mark)

    def __exit__(self, *exc):
        m = _marks
        self._mark[1] = _next_seq()
        m.open = [mk for mk in m.open if mk is not self._mark]
        if len(m.closed) >= _MAX_CLOSED:
            del m.closed[: _MAX_CLOSED // 2]
        m.closed.append(self._mark)
        return self._range.__exit__(*exc)


def span(name: str, args=None):
    """The registered span ``name`` as a context manager (see the
    module's docstring); ``args`` (any value, made a string) is recorded
    with the range."""
    if name not in SPAN_NAMES:
        raise ValueError(
            f"unregistered telemetry span {name!r}; add it to "
            f"telemetry/sections.py SPAN_SPECS")
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, args)


def _innermost(marks: list, starts: list, seq: int) -> str | None:
    """The name of the innermost of ``marks`` (sorted by start and
    opening) whose interval holds ``seq``, or None."""
    i = bisect.bisect_right(starts, seq) - 1
    mark = marks[i] if i >= 0 else None
    while mark is not None and mark[1] is not None and seq >= mark[1]:
        mark = mark[4]
    return mark[2] if mark is not None else None


def tag_backward(*roots: torch.Tensor) -> None:
    """Hook the nodes of the graph behind ``roots`` made since the last
    call on this thread, so that their backward runs in their spans'
    ranges (see the module's docstring). Does nothing while no profiler
    collects."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    m = _marks
    low, high = m.walked, _next_seq()
    m.walked = high
    marks = sorted(m.closed + m.open, key=lambda mk: (mk[0], mk[3]))
    starts = [mk[0] for mk in marks]
    m.closed.clear()
    todo = [r.grad_fn for r in roots if r.grad_fn is not None]
    nodes = {}
    while todo:
        node = todo.pop()
        seq = node._sequence_nr()
        if not low <= seq < high or seq in nodes:
            continue
        nodes[seq] = node
        todo.extend(fn for fn, _ in node.next_functions if fn is not None)
    # Autograd runs one device's ready nodes highest number first, and a
    # node's inputs come from lower numbers: the nodes run in falling
    # number, so only the first node of each run of one span needs a hook.
    last = ()
    for seq in sorted(nodes, reverse=True):
        name = _innermost(marks, starts, seq)
        if name != last:
            nodes[seq].register_prehook(_backward_hook(name))
            last = name


# Each thread's open backward range: ``{thread: [graph task, span name,
# entered range or None]}``. A backward range is torch's C-level
# ``RecordFunctionFast``: entering and leaving it calls no operator, so a
# hook on autograd's thread keeps the GIL throughout. With operator calls
# (``record_function``), which hand the GIL back midway, the hooks cost a
# traced gpt2-xl step on an H100 ~80 ms, all of it idle on the card.
_backward_open: dict = {}


@functools.cache
def _backward_hook(name: str | None):
    def hook(grad_outputs):
        _switch_backward(name)
    return hook


def _switch_backward(name: str | None) -> None:
    thread = threading.get_ident()
    task = torch._C._current_graph_task_id()
    now = _backward_open.get(thread)
    if now is not None and now[0] == task and now[1] == name:
        return
    if now is not None:
        _close(now)
    if now is None or now[0] != task:
        torch.autograd.Variable._execution_engine.queue_callback(
            functools.partial(_end_backward, thread, task))
    entered = None
    if name is not None and _autograd_profiler._is_profiler_enabled:
        entered = torch._C._profiler._RecordFunctionFast("kftpu." + name)
        entered.__enter__()
    _backward_open[thread] = [task, name, entered]


def _close(now: list) -> None:
    if now[2] is not None:
        now[2].__exit__(None, None, None)
        now[2] = None


def _end_backward(thread: int, task: int) -> None:
    now = _backward_open.get(thread)
    if now is not None and now[0] == task:
        del _backward_open[thread]
        _close(now)


def collective(name: str, op, *operands, **kwargs):
    """``op(*operands, **kwargs)`` inside the registered section ``name``;
    in serialize mode fenced on both sides (:func:`_fence`)."""
    if name not in SECTION_NAMES:
        raise ValueError(
            f"unregistered telemetry section {name!r}; add it to "
            f"telemetry/sections.py SECTION_SPECS")
    with _range(name):
        if not _serialize:
            return op(*operands, **kwargs)
        _fence()
        out = op(*operands, **kwargs)
        _fence()
        return out
