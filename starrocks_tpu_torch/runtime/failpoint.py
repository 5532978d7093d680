"""Failpoints: runtime-toggleable fault injection.

Reference behavior: be/src/base/failpoint/fail_point.h:21 (named failpoints
toggled at runtime via RPC, scripted by SQL regression suites). Here: a
process-wide registry; `fail_point(name)` is compiled into host-side code
paths and raises / calls the injected action when armed. Tests use
`scoped(name, ...)`.
"""

from __future__ import annotations

from contextlib import contextmanager

from .. import lockdep


class FailPointError(RuntimeError):
    pass


class _Registry:
    def __init__(self):
        self._lock = lockdep.lock("failpoint._Registry._lock")
        self._armed: dict = {}  # guarded_by: _lock
        self._hits: dict = {}   # guarded_by: _lock

    def arm(self, name: str, action=None, times: int | None = None):
        """action: None -> raise FailPointError; callable -> invoked."""
        with self._lock:
            self._armed[name] = {"action": action, "times": times}

    def disarm(self, name: str):
        with self._lock:
            self._armed.pop(name, None)

    def hit(self, name: str):
        with self._lock:
            self._hits[name] = self._hits.get(name, 0) + 1
            ent = self._armed.get(name)
            if ent is None:
                return
            if ent["times"] is not None:
                if ent["times"] <= 0:
                    return
                ent["times"] -= 1
        # armed path only (disarmed sites return above): journal the
        # trigger before the fault fires, outside the registry lock
        from . import events

        events.emit("failpoint_trigger", site=name)
        if ent["action"] is None:
            raise FailPointError(f"failpoint {name!r} triggered")
        ent["action"]()

    def hits(self, name: str) -> int:
        with self._lock:
            return self._hits.get(name, 0)

    def list(self):
        with self._lock:
            return sorted(self._armed)

    def snapshot(self):
        """[(name, armed, times_remaining, hits)] over every failpoint ever
        hit or currently armed — the information_schema.fail_points /
        HTTP metrics surface. times_remaining -1 = unlimited."""
        with self._lock:
            names = sorted(set(self._armed) | set(self._hits))
            out = []
            for n in names:
                ent = self._armed.get(n)
                times = -1
                if ent is not None and ent["times"] is not None:
                    times = int(ent["times"])
                out.append((n, ent is not None, times,
                            self._hits.get(n, 0)))
            return out


_registry = _Registry()


def fail_point(name: str):
    """Insert into host code paths: no-op unless armed."""
    _registry.hit(name)


def arm(name: str, action=None, times=None):
    _registry.arm(name, action, times)


def disarm(name: str):
    _registry.disarm(name)


def snapshot():
    return _registry.snapshot()


def hits(name: str) -> int:
    return _registry.hits(name)


def set_from_sql(name: str, value: str):
    """The `ADMIN SET failpoint '<name>' = '<value>'` surface (reference:
    the fail-point RPC scripted by SQL regression suites). Values:
    'enable' (raise on hit), 'enable:times=N' (raise for the next N hits),
    'disable'."""
    v = str(value).strip().lower()
    if v == "disable":
        disarm(name)
        return
    if v == "enable":
        arm(name)
        return
    if v.startswith("enable:"):
        opt = v[len("enable:"):]
        if opt.startswith("times="):
            try:
                times = int(opt[len("times="):])
            except ValueError:
                raise ValueError(
                    f"bad failpoint times in {value!r}") from None
            arm(name, times=times)
            return
    raise ValueError(
        f"unknown failpoint action {value!r}: expected "
        "'enable', 'enable:times=N', or 'disable'")


def render_prometheus() -> str:
    """Armed flags + hit counters as Prometheus text (appended to the HTTP
    /metrics payload next to the main registry's render)."""
    rows = _registry.snapshot()
    if not rows:
        return ""
    out = ["# TYPE sr_tpu_failpoint_armed gauge"]
    for n, armed, _times, _hits in rows:
        out.append(f'sr_tpu_failpoint_armed{{name="{n}"}} {int(armed)}')
    out.append("# TYPE sr_tpu_failpoint_hits counter")
    for n, _armed, _times, h in rows:
        out.append(f'sr_tpu_failpoint_hits{{name="{n}"}} {h}')
    return "\n".join(out) + "\n"


@contextmanager
def scoped(name: str, action=None, times=None):
    arm(name, action, times)
    try:
        yield
    finally:
        disarm(name)
