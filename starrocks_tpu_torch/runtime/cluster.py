"""Multi-host cluster plumbing: liveness (heartbeat + failure detection,
restart hooks) and the cross-process mesh bootstrap.

Reference behavior:
- heartbeat plane: the FE heartbeat RPC every BE answers
  (be/src/agent/heartbeat_server.h:55) and the FE-side node liveness
  tracking that marks backends dead and reroutes work;
- data plane: the BE<->BE exchange RPCs (gensrc/proto/
  internal_service.proto:802-851) carrying shuffled chunks over the
  network with async send buffers (be/src/exec/pipeline/exchange/
  sink_buffer.h:79).

A port of the JAX package's runtime/cluster.py. The DATA plane across
processes is the mesh's collectives (all_to_all / all_gather / all_reduce
over a torch.distributed process group): on the device tensors over NCCL
where every rank has a card of its own (parallel/mesh.Nccl), else staged
through host memory over gloo (parallel/mesh.Gloo), so one distributed
program covers one process or several, on one host or several, as
jax.distributed spans one mesh over a pod's hosts (in-host hops over
NVLink or PCIe, cross-host hops over the network, picked by NCCL, not by
engine code). What remains here is the CONTROL plane:
  * host_layout(table)     — each rank's local rank and cards, and the
                             group's backend, from every rank's host and
                             visible cards (process_backend: one host);
  * init_multihost(...)    — publish this rank's host and cards, read
                             every rank's, bind this rank's first card and
                             join the process group the mesh spans;
  * ClusterMonitor         — coordinator-side heartbeat registry,
                             failure detection, on_failure restart hooks;
  * Heartbeater            — worker-side periodic beat.
The socket exchange plane between a coordinator and worker processes is
runtime/cluster_exec.py.
"""

from __future__ import annotations

import http.client
import http.server
import json
import threading
import time
from typing import Callable, NamedTuple, Optional

from .. import lockdep
from .metrics import metrics

ALIVE = "ALIVE"
DEAD = "DEAD"

WORKERS_DEAD = metrics.gauge(
    "sr_tpu_cluster_workers_dead",
    "registered workers currently marked DEAD by the liveness watchdog "
    "(feeds the default heartbeat_loss alert rule)")


def process_backend(cards: int, procs_on_host: int) -> str:
    """The backend of a process group's device collectives when every rank
    runs on one host (host_layout's answer for that host alone): "nccl"
    when the host has cards and each of its `procs_on_host` processes a
    card of its own, "gloo" otherwise (no card, or processes sharing a
    card: NCCL refuses two ranks on one device)."""
    return host_layout([("", cards)] * procs_on_host)[0]


class RankPlace(NamedTuple):
    """One rank's place in a process mesh over hosts: its host, its index
    among that host's ranks (in global rank order) and the cards of its
    host it holds (indices among the cards its host makes visible; none:
    the rank runs on the CPU)."""
    host: str
    local_rank: int
    cards: tuple


def host_layout(table) -> tuple:
    """The layout of a process mesh over hosts. `table` is every rank's
    (host, visible cards), in rank order; returns (the group's backend,
    [RankPlace of each rank]). A host's ranks are ordered by global rank
    (they need not be consecutive). With p ranks on a host of c >= p
    cards, local rank i holds the c // p cards from card i * (c // p) on;
    with p > c it shares card i % c; with no card it runs on the CPU. The
    backend is "nccl" only when every host has cards and no two ranks
    share one, "gloo" otherwise: every rank computes the same answer from
    the same table."""
    by_host: dict = {}
    for r, (host, _) in enumerate(table):
        by_host.setdefault(host, []).append(r)
    places = [None] * len(table)
    nccl = True
    for host, ranks in by_host.items():
        counts = sorted({int(table[r][1]) for r in ranks})
        if len(counts) > 1:
            raise ValueError(f"the ranks of host {host!r} see {counts} "
                             "cards: one host, one card count")
        c, p = counts[0], len(ranks)
        nccl = nccl and 0 < c and p <= c
        for i, r in enumerate(ranks):
            if not c:
                cards = ()
            elif p <= c:
                cards = tuple(range(i * (c // p), (i + 1) * (c // p)))
            else:
                cards = (i % c,)
            places[r] = RankPlace(host, i, cards)
    return ("nccl" if nccl else "gloo"), places


class RanksMissing(RuntimeError):
    """The process mesh's rendezvous ended before every rank was heard
    from; `missing` names those ranks."""

    def __init__(self, missing, coordinator_address: str, timeout_s: float):
        self.missing = list(missing)
        super().__init__(
            f"process mesh at {coordinator_address}: ranks {self.missing} "
            f"not heard from within {timeout_s:g} s")


def _await_ranks(table, keys, timeout_s: float, coordinator_address: str):
    """Wait for every key of the rendezvous table, in rank order, within
    one deadline; raise RanksMissing naming the first rank not heard from
    and every later one not there either. Waiting in order names them
    even when the coordinator's store goes away (a peer gave up first):
    the ranks before are known to be there."""
    import datetime

    import torch.distributed as dist

    end = time.monotonic() + timeout_s
    # lint: checkpoint-exempt — process start-up, not query context; one deadline bounds every wait
    for i, k in enumerate(keys):
        left = max(end - time.monotonic(), 1e-3)
        try:
            table.wait([k], datetime.timedelta(seconds=left))
        except dist.DistError as e:
            missing = [int(k)] + [int(x) for x in keys[i + 1:]
                                  if not _published(table, x)]
            raise RanksMissing(missing, coordinator_address,
                               timeout_s) from e


def _published(table, key: str) -> bool:
    """Whether the key is in the table; False where the store is gone."""
    import torch.distributed as dist

    try:
        return table.check([key])
    except dist.DistError:
        return False


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, local_device_count: int | None = None,
                   timeout_s: float | None = None, host: str | None = None):
    """Join the cross-process group and return the GLOBAL shard ids.
    `coordinator_address` is host:port of the store rank 0 serves;
    `timeout_s` bounds the rendezvous and every collective (torch's
    default where None); `host` names this rank's host (default the
    machine's host name, `platform.node()`; a launcher or an emulated host
    names it).

    First each rank publishes (host, visible cards) in the store and reads
    every rank's (the rendezvous: a rank not heard from within the
    timeout raises RanksMissing naming it; a rank that cannot reach rank
    0's store gives up within about half of it: torch's client is given a
    quarter, and retries once after a backoff).
    host_layout then gives this rank its cards and the group its backend;
    the rank binds its first card, and only then the group is created on
    the same store: with NCCL one group `cpu:gloo,cuda:nccl` (its NCCL side
    on that card), otherwise gloo alone. Each rank then holds
    `local_device_count` shards (default 1) of the meshes
    parallel/mesh.make_mesh builds, spread over its cards. The layout is
    recorded for make_mesh; nothing falls back from one backend to the
    other."""
    import datetime
    import platform

    import torch
    import torch.distributed as dist

    from ..parallel import mesh

    host = host or platform.node()
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    wait = (datetime.timedelta(seconds=timeout_s) if timeout_s is not None
            else dist.constants.default_pg_timeout)
    addr, port = coordinator_address.rsplit(":", 1)
    try:
        store = dist.TCPStore(addr, int(port), num_processes,
                              process_id == 0, timeout=wait / 4,
                              wait_for_workers=False)
    except dist.DistError as e:
        if process_id == 0:
            raise
        raise RanksMissing([0], coordinator_address,
                           wait.total_seconds()) from e
    store.set_timeout(wait)
    table = dist.PrefixStore("host_layout", store)
    table.set(str(process_id), json.dumps([host, cards]))
    keys = [str(r) for r in range(num_processes)]
    _await_ranks(table, keys, wait.total_seconds(), coordinator_address)
    backend, places = host_layout(
        [tuple(json.loads(table.get(k))) for k in keys])
    mine = places[process_id]
    kw = {"backend": "gloo"}
    if mine.cards:
        card = torch.device("cuda", mine.cards[0])
        torch.cuda.set_device(card)
        if backend == "nccl":
            kw = {"backend": "cpu:gloo,cuda:nccl", "device_id": card}
    if timeout_s is not None:
        kw["timeout"] = wait
    dist.init_process_group(store=store, world_size=num_processes,
                            rank=process_id, **kw)
    mesh._PROCESS.update(local_shards=int(local_device_count or 1),
                         backend=backend, host=host, cards=mine.cards)
    return tuple(range(num_processes * mesh._PROCESS["local_shards"]))


class ClusterMonitor:
    """Coordinator-side liveness registry (the FE heartbeat mgr analog).

    Workers POST /heartbeat {"id": ...}; a watchdog marks a worker DEAD
    once its last beat is older than interval_s * miss_limit and fires
    on_failure(worker_id) EXACTLY ONCE per down transition — the restart
    hook (respawn the worker, reassign its shards). A worker that beats
    again after being marked DEAD transitions back to ALIVE."""

    def __init__(self, port: int = 0, interval_s: float = 0.2,
                 miss_limit: int = 3,
                 on_failure: Optional[Callable[[str], None]] = None,
                 bind_host: str = "0.0.0.0"):
        """bind_host defaults to all interfaces so workers on OTHER hosts
        can reach /heartbeat (a 127.0.0.1 bind would silently limit the
        failure detector to same-machine workers); pass '127.0.0.1' to
        keep a test monitor loopback-only."""
        self.interval_s = interval_s
        self.miss_limit = miss_limit
        self.on_failure = on_failure
        self._lock = lockdep.lock("ClusterMonitor._lock")
        self._beats: dict = {}   # guarded_by: _lock — id -> last beat
        self._state: dict = {}   # guarded_by: _lock — id -> ALIVE | DEAD
        self._reg: dict = {}     # guarded_by: _lock — id -> beat payload
        #   (addr + addressable fragments): every beat re-registers, so a
        #   worker returning from DEAD re-advertises without extra RPCs
        mon = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/heartbeat" and "id" in body:
                    try:
                        info = {k: v for k, v in body.items() if k != "id"}
                        mon.beat(str(body["id"]), info or None)
                        self.send_response(200)
                    except Exception:  # noqa: BLE001  # lint: swallow-ok —
                        # injected/receiver faults answer 500; the worker's
                        # backoff ladder treats it as a missed beat
                        self.send_response(500)
                else:
                    self.send_response(404)
                self.end_headers()

            def do_GET(self):
                if self.path == "/members":
                    out = json.dumps(mon.members()).encode()
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(out)))
                    self.end_headers()
                    self.wfile.write(out)
                else:
                    self.send_response(404)
                    self.end_headers()

            def log_message(self, *a):  # quiet
                pass

        self._srv = http.server.ThreadingHTTPServer((bind_host, port),
                                                    Handler)
        self.port = self._srv.server_address[1]
        self._threads = [  # lint: unguarded-ok — built once, never mutated
            threading.Thread(target=self._srv.serve_forever, daemon=True),
            threading.Thread(target=self._watchdog, daemon=True),
        ]
        self._stop = threading.Event()
        for t in self._threads:
            t.start()

    # --- registry ------------------------------------------------------------
    def beat(self, worker_id: str, info: dict | None = None):
        """One worker beat. `info` is the worker's registration payload
        (exchange addr, addressable fragments) — kept fresh on every
        beat. A beat from a worker currently marked DEAD is the
        RECONNECT transition: the gauge drops by exactly one (recomputed
        under the lock, so a flapping worker can't double-decrement) and
        the coordinator journals `heartbeat_reconnect` — the worker-side
        Heartbeater journals its own view in ITS process; this one is
        what the coordinator's chaos assertions observe."""
        from .failpoint import fail_point

        fail_point("heartbeat::recv")
        with self._lock:
            was = self._state.get(worker_id)
            self._beats[worker_id] = time.monotonic()
            self._state[worker_id] = ALIVE
            if info is not None:
                self._reg[worker_id] = dict(info)
            dead = sum(1 for s in self._state.values() if s == DEAD)
        WORKERS_DEAD.set(dead)
        if was == DEAD:
            from . import events

            events.emit("heartbeat_reconnect", worker=worker_id,
                        side="coordinator")

    def registration(self, worker_id: str) -> dict:
        """Latest beat payload the worker advertised (addr/fragments)."""
        with self._lock:
            return dict(self._reg.get(worker_id, {}))

    def members(self) -> dict:
        with self._lock:
            now = time.monotonic()
            return {
                w: {"state": self._state[w],
                    "age_s": round(now - self._beats[w], 3)}
                for w in sorted(self._beats)
            }

    def _watchdog(self):
        while not self._stop.wait(self.interval_s / 2):
            self._scan(time.monotonic())

    def _scan(self, now: float):
        """One watchdog pass at clock value `now` (separated from the
        thread loop so tests drive ALIVE->DEAD transitions with a fake
        clock): promote workers whose last beat is too old to DEAD,
        journal `heartbeat_loss` once per down transition, fire the
        restart hook outside the lock."""
        deadline = self.interval_s * self.miss_limit
        fire = []
        with self._lock:
            for w, last in self._beats.items():
                if now - last > deadline and self._state[w] == ALIVE:
                    self._state[w] = DEAD
                    fire.append(w)
            dead = sum(1 for s in self._state.values() if s == DEAD)
        WORKERS_DEAD.set(dead)
        for w in fire:  # hooks + journal run outside the lock
            from . import events

            events.emit("heartbeat_loss", worker=w, side="coordinator")
            if self.on_failure is not None:
                try:
                    self.on_failure(w)
                except Exception:  # noqa: BLE001  # lint: swallow-ok — liveness must survive
                    pass

    def close(self):
        self._stop.set()
        self._srv.shutdown()
        self._srv.server_close()


class Heartbeater:
    """Worker-side periodic beat (the BE heartbeat answer analog).

    Reconnect policy: capped exponential backoff with jitter. A healthy
    coordinator is probed every `interval_s`; after k consecutive failed
    beats the delay grows to min(interval_s * 2^k, max_backoff_s), then a
    uniform jitter in [0.5, 1.0) of that value spreads a fleet of workers
    whose coordinator just restarted (the thundering-herd guard the old
    fixed-interval probe lacked). One successful beat resets the ladder."""

    def __init__(self, host: str, port: int, worker_id: str,
                 interval_s: float = 0.2, max_backoff_s: float = 5.0,
                 rng=None, autostart: bool = True, _wait=None,
                 payload: dict | None = None):
        """`rng` and `_wait` are injection points for deterministic tests
        (a seeded Random and a fake-clock wait); `autostart=False` builds
        the beater without its thread for unit-testing the policy.
        `payload` rides every beat body (the worker's registration:
        exchange addr, addressable fragments) so a reconnect after DEAD
        re-registers with no extra round-trip."""
        import random

        self.host, self.port = host, port
        self.worker_id = worker_id
        self.payload = dict(payload or {})
        self.interval_s = interval_s
        self.max_backoff_s = max_backoff_s
        self._failures = 0
        self._rng = rng or random.Random()
        self._stop = threading.Event()
        self._wait = _wait or self._stop.wait
        self._t = None
        if autostart:
            self._t = threading.Thread(target=self._run, daemon=True)
            self._t.start()

    def _next_delay(self) -> float:
        """Seconds until the next beat given the consecutive-failure count
        (pure: the unit-testable policy)."""
        if self._failures == 0:
            return self.interval_s
        backoff = min(self.interval_s * (2 ** self._failures),
                      self.max_backoff_s)
        return backoff * (0.5 + self._rng.random() / 2)

    def _beat_once(self) -> bool:
        from .failpoint import FailPointError, fail_point

        try:
            fail_point("heartbeat::send")
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=2)
            try:
                conn.request("POST", "/heartbeat",
                             json.dumps({"id": self.worker_id,
                                         **self.payload}),
                             {"Content-Type": "application/json"})
                conn.getresponse().read()
            finally:
                # an OSError from request/getresponse must not leak the
                # socket — before this finally, every failed beat left
                # one behind (effects_check contract 1 caught it)
                conn.close()
            return True
        except (OSError, FailPointError):
            return False  # coordinator away (or injected fault): back off

    def _observe(self, ok: bool):
        """Fold one beat outcome into the failure ladder AND the event
        journal. The ladder reset used to be silent: a reconnect after
        capped backoff left no record that the worker had ever been away
        — the `heartbeat_reconnect` event (with the failure count it
        recovered from) is the observable. Loss is journaled once per
        outage, on the 0 -> 1 transition."""
        from . import events

        if ok:
            if self._failures:
                events.emit("heartbeat_reconnect", worker=self.worker_id,
                            after_failures=self._failures)
            self._failures = 0
            return
        self._failures += 1
        if self._failures == 1:
            events.emit("heartbeat_loss", worker=self.worker_id)

    def _run(self):
        while not self._stop.is_set():
            self._observe(self._beat_once())
            self._wait(self._next_delay())

    def stop(self):
        """Silence the worker (the crash simulation in tests)."""
        self._stop.set()
        if self._t is not None:
            self._t.join(timeout=2)
