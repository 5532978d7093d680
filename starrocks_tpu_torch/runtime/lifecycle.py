"""Query lifecycle hooks: stage checkpoints and memory accounting.

Reference behavior: the BE's per-query lifecycle (runtime/query_context.h
— cancellation checked at operator boundaries, MemTracker charges per
materialized buffer). A part of the JAX package's runtime/lifecycle.py:
only the hooks the spill executors and the query cache call —
`current`, `checkpoint`, `account`, `_nbytes` and `degraded`.

The reference runs every statement inside `query_scope`, which installs a
QueryContext (deadline, KILL flag, memory limits) on the thread. The port
has no query scopes yet: they come with KILL and memory limits in slice 8.
Until then no context is ever active, so every hook here does nothing —
exactly what the reference's hooks do outside a scope. `_nbytes` already
measures what the spill loops hand it (torch tensors, device Chunks,
HostTables, numpy arrays and tuples of them), so the accountant of slice 8
can charge them unchanged.
"""

from __future__ import annotations

import threading

_tls = threading.local()


def current():
    """The thread's active query context (always None until slice 8 brings
    query scopes)."""
    return getattr(_tls, "ctx", None)


def checkpoint(stage: str):
    """Stage-boundary hook: no-op without an active context; raises the
    context's typed lifecycle error otherwise."""
    ctx = current()
    if ctx is not None:
        ctx.check(stage)


def _nbytes(obj) -> int:
    """Estimated bytes of a materialized buffer: a torch tensor or numpy
    array, a device Chunk (data and validity tensors), a HostTable (arrays
    and valid masks), or a tuple/list of those."""
    n = getattr(obj, "nbytes", None)
    if n is not None:
        return int(n)
    total = 0
    arrays = getattr(obj, "arrays", None)  # HostTable
    if isinstance(arrays, dict):
        for a in arrays.values():
            total += int(getattr(a, "nbytes", 0) or 0)
        valids = getattr(obj, "valids", None)
        if isinstance(valids, dict):
            for v in valids.values():
                total += int(getattr(v, "nbytes", 0) or 0)
        return total
    data = getattr(obj, "data", None)  # Chunk
    if isinstance(data, tuple):
        for a in data:
            total += int(getattr(a, "nbytes", 0) or 0)
        for v in getattr(obj, "valid", ()) or ():
            total += int(getattr(v, "nbytes", 0) or 0)
        sel = getattr(obj, "sel", None)
        total += int(getattr(sel, "nbytes", 0) or 0)
        return total
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(x) for x in obj)
    return 0


def account(obj, stage: str):
    """Charge the active query for a materialized buffer (no-op outside a
    scope, which is always, until slice 8)."""
    ctx = current()
    if ctx is None:
        return
    n = _nbytes(obj)
    if n:
        ctx.charge(n, stage)


def degraded() -> bool:
    """True when the active query crossed its soft memory limit: callers
    degrade gracefully (decline cache admission, shrink batch slices)."""
    ctx = current()
    return ctx is not None and ctx.degraded
