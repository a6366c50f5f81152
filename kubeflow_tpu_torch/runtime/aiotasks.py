"""Task-teardown helper shared by every component that owns tasks.

``reap`` is the one audited place a cancelled task's outcome may be
dropped: on shutdown the owner cancels its tasks and awaits them so
cancellation actually lands before the process (or test) moves on —
and at that point the task's result is noise. A real failure was
already surfaced by the task itself while it ran (workqueue backoff,
informer relist counters, log lines); re-raising it out of ``stop()``
would turn every teardown into a crash lottery.

Grown out of the ``exception-swallow`` pass: five copies of the
``try: await task / except (CancelledError, Exception): pass`` idiom
(manager, informer, leader election, podsim, chaos harness) became this
one documented swallow.

The port's copy of ``kubeflow_tpu/runtime/aiotasks.py``: it keeps its own
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import asyncio


async def reap(*tasks: asyncio.Task | None) -> None:
    """Await already-cancelled (or finished) tasks, discarding outcomes.

    Call AFTER ``task.cancel()``: this only reaps — it does not cancel.
    ``None`` entries are skipped so callers can pass optional task
    slots without guarding.
    """
    for task in tasks:
        if task is None:
            continue
        try:
            await task
        except (asyncio.CancelledError, Exception):  # kftpu: ignore[exception-swallow] teardown reaper — the task surfaced its own failures while alive; stop() must not crash on them
            pass
