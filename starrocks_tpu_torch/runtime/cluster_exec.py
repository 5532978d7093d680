"""Multi-process cluster runtime: a coordinator schedules per-fragment
programs onto N worker processes over a host-side exchange plane.

Reference behavior: the FE coordinator deploying plan fragments to BEs
over bRPC and surviving their loss (qe/DefaultCoordinator.java:599
deliverExecFragments; the scheduler re-places fragments when a backend
drops out of the liveness set). A port of the JAX package's
runtime/cluster_exec.py. The in-mesh fragment path (dist_executor.py)
spans processes over gloo; this plane is independent of it: fragment
boundaries cross processes as length-prefixed columnar batches over plain
TCP sockets, and each worker runs its fragments on its own in-process
mesh, on the device its bootstrap names.

Topology and contract:

- ``ClusterRuntime`` (coordinator side) spawns N worker processes
  (``python -m starrocks_tpu_torch.runtime.cluster_exec``), bootstraps
  each with the catalog's DDL + table data + the planner thresholds that
  make fragment-IR derivation deterministic + the device to run on, and schedules fragments in
  topo order: the pickled optimized logical plan ships once per
  (worker, plan); the worker re-derives the IDENTICAL FragmentIR
  (plans are frozen dataclasses — equality survives the wire) and runs
  one fragment per request through its own adaptive overflow loop.
  Boundary outputs come back as host numpy arrays and are cached
  coordinator-side, which is what makes worker-loss retry cheap:
  re-placement re-runs ONE fragment, never the whole query.
- Liveness rides the existing heartbeat plane (runtime/cluster.py):
  workers beat into the coordinator's ClusterMonitor; a missed worker
  is promoted to DEAD (gauge + coordinator-side ``heartbeat_loss``
  event), and in-flight fragments on it are re-placed onto ALIVE
  workers, bounded by ``SET cluster_fragment_retries`` — exhaustion
  raises :class:`WorkerLostError` (worker id + fragment id) through the
  normal query unwind, so a lost worker can never wedge a query or
  corrupt the catalog.
- Partitioned (blackholed/delayed) sockets are bounded by
  ``cluster_exec_timeout_s``: the coordinator's receive loop polls with
  short socket timeouts, runs ``lifecycle.checkpoint`` each wait (so
  KILL/deadline fire mid-exchange) and consults the monitor — a worker
  that neither answers nor beats is declared lost for the fragment.

Wire protocol: every message is two length-prefixed frames (8-byte
big-endian lengths): a JSON header frame and a pickle payload frame.
Chunk payloads travel as numpy arrays (dist_executor.chunk_to_host) and
HostTables are numpy-backed, so the pickle body IS the columnar batch. The plane is trusted-transport only (pickle over
loopback/LAN between processes this module itself spawned).
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import socket
import struct
import subprocess
import sys
import time

from .. import lockdep
from . import lifecycle
from .cluster import DEAD, ClusterMonitor
from .config import config
from .failpoint import fail_point
from .metrics import metrics

CLUSTER_WORKERS = metrics.gauge(
    "sr_tpu_cluster_workers",
    "worker processes currently registered with the cluster runtime")
FRAGMENTS_TOTAL = metrics.counter(
    "sr_tpu_cluster_fragments_total",
    "fragments scheduled onto cluster workers (successful attempts)")
RETRIES_TOTAL = metrics.counter(
    "sr_tpu_cluster_fragment_retries_total",
    "fragment re-placements after a worker was declared lost mid-query")

_LEN = struct.Struct(">Q")
_MAX_FRAME = 1 << 31  # 2 GiB: a torn/garbage length fails fast

# config knobs a worker inherits from its coordinator so plan lowering
# and the adaptive loop behave identically on both sides of the wire
_SHIPPED_KNOBS = ("max_recompiles", "join_expand_headroom",
                  "dist_fragments", "segment_strategy",
                  "join_probe_strategy", "topn_strategy")


class WorkerLostError(RuntimeError):
    """A fragment's worker died (or partitioned away) and the
    re-placement budget (`cluster_fragment_retries`) is exhausted."""

    def __init__(self, worker_id: str, fid: int, reason: str):
        super().__init__(
            f"cluster worker {worker_id!r} lost while executing fragment "
            f"{fid} and retries exhausted: {reason}")
        self.worker_id = worker_id
        self.fid = fid
        self.reason = reason


class _WorkerGone(Exception):
    """Internal: one attempt's worker is unreachable/dead/partitioned
    (retryable — distinct from a deterministic in-query error, which the
    worker reports in-band and must NOT be retried)."""

    def __init__(self, worker_id: str, reason: str):
        super().__init__(f"{worker_id}: {reason}")
        self.worker_id = worker_id
        self.reason = reason


class WorkerQueryError(RuntimeError):
    """The fragment itself failed ON the worker (engine error, injected
    failpoint): deterministic, reported in-band, never retried."""

    def __init__(self, worker_id: str, etype: str, msg: str):
        super().__init__(f"[worker {worker_id}] {etype}: {msg}")
        self.worker_id = worker_id
        self.etype = etype


# --- framing -----------------------------------------------------------------


def _send_msg(sock, header: dict, payload=None, on_wait=None):
    """One message = JSON header frame + pickle payload frame. Sends in
    bounded slices so a slow/partitioned peer ticks `on_wait` (the
    coordinator's checkpoint/deadline probe) instead of wedging."""
    fail_point("cluster::send")
    hb = json.dumps(header).encode()
    pb = b"" if payload is None else pickle.dumps(payload, protocol=4)
    data = memoryview(
        _LEN.pack(len(hb)) + hb + _LEN.pack(len(pb)) + pb)
    off = 0
    while off < len(data):
        try:
            off += sock.send(data[off:off + (1 << 20)])
        except socket.timeout:
            if on_wait is not None:
                on_wait()


def _recv_exact(sock, n: int, on_wait=None) -> bytes:
    """Read exactly n bytes; socket-timeout ticks call `on_wait` (the
    coordinator's checkpoint/deadline/liveness probe) and retry."""
    buf = bytearray()
    while len(buf) < n:
        try:
            part = sock.recv(min(n - len(buf), 1 << 20))
        except socket.timeout:
            if on_wait is not None:
                on_wait()
            continue
        if not part:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(part)
    return bytes(buf)


def _recv_msg(sock, on_wait=None):
    fail_point("cluster::recv")
    (hn,) = _LEN.unpack(_recv_exact(sock, _LEN.size, on_wait))
    if hn > _MAX_FRAME:
        raise ConnectionError(f"bad header length {hn}")
    header = json.loads(_recv_exact(sock, hn, on_wait) or b"{}")
    (pn,) = _LEN.unpack(_recv_exact(sock, _LEN.size, on_wait))
    if pn > _MAX_FRAME:
        raise ConnectionError(f"bad payload length {pn}")
    payload = pickle.loads(_recv_exact(sock, pn, on_wait)) if pn else None
    return header, payload


# --- worker side -------------------------------------------------------------


class ClusterWorker:
    """One worker process's serving loop: a fresh Session bootstrapped
    from the coordinator's catalog, a DistExecutor over this process's
    own in-process mesh, and a one-request-per-connection accept
    loop — fragment execution is serialized per worker by construction,
    mirroring a BE's single exec thread per fragment instance."""

    def __init__(self, worker_id: str, shards: int, port: int = 0,
                 bind_host: str = "127.0.0.1"):
        self.worker_id = worker_id
        self.shards = shards
        self.sess = None  # built at BOOTSTRAP (the catalog arrives then)
        self.de = None
        self._plans: dict = {}  # plan fingerprint -> (plan, ir, scans_meta)
        self._chaos: dict = {}  # armed fault: {"action","seconds","times"}
        self._stop = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        bound = False
        try:
            self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._srv.bind((bind_host, port))
            self._srv.listen(16)
            self.port = self._srv.getsockname()[1]
            bound = True
        finally:
            if not bound:  # bind/listen failed: no half-open listener
                self._srv.close()

    # -- request handlers ----------------------------------------------------

    def _bootstrap(self, payload) -> dict:
        from ..sql import distributed
        from .session import Session

        th = payload.get("thresholds", {})
        if "shard_threshold_rows" in th:
            distributed.SHARD_THRESHOLD_ROWS = int(
                th["shard_threshold_rows"])
        if "shuffle_agg_min_groups" in th:
            distributed.SHUFFLE_AGG_MIN_GROUPS = int(
                th["shuffle_agg_min_groups"])
        for k, v in payload.get("knobs", {}).items():
            config.set(k, v, force=True)
        # the coordinator names the device: a worker never picks one. Its
        # card becomes the process's current one, so a bare `cuda` there
        # means that card too
        import torch

        dev = torch.device(payload["device"])
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        self.sess = Session(dist_shards=self.shards, device=dev)
        for ddl in payload.get("ddl", ()):
            self.sess.sql(ddl)
        for name, data in payload.get("tables", {}).items():
            self._load_table(name, data)
        self.de = self.sess._executor()
        self._plans.clear()
        return {"ok": True, "tables": len(payload.get("tables", {}))}

    def _load_table(self, name: str, data):
        handle = self.sess.catalog.get_table(name)
        if handle is None:
            raise ValueError(f"sync for unknown table {name!r}")
        self.sess._replace_table_data(handle, data)

    def _sync_table(self, payload) -> dict:
        self._load_table(payload["name"], payload["data"])
        # a re-synced table invalidates any IR derived over stale modes
        self._plans.clear()
        return {"ok": True}

    def _exec_fragment(self, payload) -> dict:
        from .dist_executor import chunk_from_host, chunk_to_host

        fail_point("cluster::worker_exec")
        fp = payload["fp"]
        entry = self._plans.get(fp)
        if entry is None:
            blob = payload.get("plan")
            if blob is None:
                return {"ok": False, "unknown_plan": True}
            plan = pickle.loads(blob)
            ir, scans_meta = self.de._fragment_ir(plan)
            # ir.plan, not the fresh unpickle: the IR memo hits on plan
            # equality and fragment roots belong to the derivation plan
            entry = (ir.plan, ir, scans_meta)
            if len(self._plans) > 128:
                self._plans.clear()
            self._plans[fp] = entry
        plan, ir, scans_meta = entry
        fid = int(payload["fid"])
        frag = ir.fragments[fid]
        mesh = self.de.mesh
        bnd = tuple(chunk_from_host(b, mesh.device, mesh.local_devices)
                    for b in payload.get("bnd", ()))

        def attempt(caps, p):
            inputs = self.de._place(scans_meta)
            out, checks = self.de.run_fragment(
                plan, frag, caps, inputs, bnd, scans_meta)
            return out, self.de._read(checks)

        from .profile import RuntimeProfile

        out = self.de._adaptive(RuntimeProfile("fragment"), attempt)
        return {"ok": True, "out": chunk_to_host(out),
                "stats": {"fid": fid, "worker": self.worker_id}}

    def _apply_chaos(self) -> bool:
        """Consume one armed fault before answering an EXEC_FRAGMENT.
        Returns True when the reply must be suppressed (blackhole)."""
        ch = self._chaos
        if not ch or ch.get("times", 0) <= 0:
            return False
        ch["times"] -= 1
        time.sleep(float(ch.get("seconds", 0.0)))
        return ch.get("action") == "blackhole"

    def _handle(self, header: dict, payload) -> dict | None:
        """Returns the reply payload, or None to suppress the reply."""
        t = header.get("type")
        if t == "PING":
            return {"ok": True, "worker": self.worker_id}
        if t == "BOOTSTRAP":
            return self._bootstrap(payload)
        if t == "SYNC_TABLE":
            return self._sync_table(payload)
        if t == "EXEC_FRAGMENT":
            if self._apply_chaos():
                return None  # blackhole: hold the socket, never answer
            return self._exec_fragment(payload)
        if t == "CHAOS":
            self._chaos = dict(payload or {})
            return {"ok": True}
        if t == "SHUTDOWN":
            self._stop = True
            return {"ok": True}
        return {"ok": False, "error": f"unknown message type {t!r}"}

    def serve_forever(self):
        """Accept loop: one request/reply per connection. Runs on the
        worker process's MAIN thread — liveness is the Heartbeater's job,
        so a fragment that computes for seconds doesn't miss beats."""
        while not self._stop:
            try:
                conn, _addr = self._srv.accept()
            except OSError:
                break  # listening socket closed under us: shutting down
            try:
                try:
                    header, payload = _recv_msg(conn)
                except (ConnectionError, EOFError, json.JSONDecodeError):
                    continue  # lint: swallow-ok — torn request, drop conn
                try:
                    reply = self._handle(header, payload)
                except Exception as e:  # noqa: BLE001  # lint: swallow-ok — converted to an in-band error reply: a worker-side engine/failpoint error becomes the coordinator's WorkerQueryError, not a worker loss
                    reply = {"ok": False, "etype": type(e).__name__,
                             "error": str(e)[:500]}
                if reply is not None:
                    try:
                        _send_msg(conn, {"re": header.get("type")}, reply)
                    except OSError:
                        pass  # lint: swallow-ok — peer gave up (timeout)
            finally:
                conn.close()
        self._srv.close()

    def close(self):
        self._stop = True
        self._srv.close()


def worker_main(argv=None) -> int:
    """Entry point for ``python -m starrocks_tpu_torch.runtime.cluster_exec``:
    build the worker, print its port for the spawning coordinator, beat
    into the coordinator's monitor, serve until SHUTDOWN."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--worker-id", required=True)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--hb-host", default="127.0.0.1")
    ap.add_argument("--hb-port", type=int, default=0)
    ap.add_argument("--hb-interval-s", type=float, default=0.2)
    a = ap.parse_args(argv)

    # load the engine (torch and its libraries) BEFORE the first beat: the
    # import holds the interpreter for seconds, which would silence the
    # heartbeat thread mid-bootstrap and get the worker declared DEAD
    from . import session  # noqa: F401

    worker = ClusterWorker(a.worker_id, a.shards)
    print(f"SR_TPU_WORKER_PORT={worker.port}", flush=True)
    hb = None
    if a.hb_port:
        from .cluster import Heartbeater

        hb = Heartbeater(
            a.hb_host, a.hb_port, a.worker_id, interval_s=a.hb_interval_s,
            payload={"addr": ["127.0.0.1", worker.port]})
    try:
        worker.serve_forever()
    finally:
        if hb is not None:
            hb.stop()
        worker.close()
    return 0


# --- coordinator side --------------------------------------------------------


class _WorkerHandle:
    """Coordinator-side record of one spawned worker process."""

    def __init__(self, worker_id: str, proc, host: str, port: int):
        self.worker_id = worker_id
        self.proc = proc  # subprocess.Popen | None (externally managed)
        self.host = host
        self.port = port
        self.synced: dict = {}  # table -> data_version shipped
        self.plans: set = set()  # plan fingerprints shipped

    def alive_process(self) -> bool:
        return self.proc is None or self.proc.poll() is None


class ClusterRuntime:
    """The coordinator: spawn/bootstrap workers, watch their liveness,
    schedule fragments with bounded re-placement on loss.

    Attach to a session via :meth:`attach` (publishes the runtime on the
    shared catalog, so every session of a serving tier routes through
    it); DistExecutor consults it per query and falls back to local
    in-mesh execution for plans below `cluster_route_min_fragments`."""

    def __init__(self, n_workers: int = 2, shards: int = 2,
                 hb_interval_s: float = 0.5, hb_miss_limit: int = 6,
                 auto_respawn: bool = False):
        """The heartbeat deadline is hb_interval_s * hb_miss_limit (3 s by
        default): a worker's beat thread shares its interpreter with the
        fragment it runs, so a shorter deadline can declare a busy worker
        DEAD."""
        self.n_workers = n_workers
        self.shards = shards
        self.auto_respawn = auto_respawn
        self._lock = lockdep.lock("ClusterRuntime._lock")
        self._workers: dict = {}  # guarded_by: _lock — id -> _WorkerHandle
        # id -> the card named in its bootstrap (kept across respawns)
        self.devices: dict = {}  # guarded_by: _lock
        self._boot_session = None
        self.retries_total = 0  # lifetime re-placements (bench summary)
        self.fragments_total = 0  # lifetime fragments run to completion
        self.monitor = ClusterMonitor(
            interval_s=hb_interval_s, miss_limit=hb_miss_limit,
            on_failure=self._on_worker_down, bind_host="127.0.0.1")

    # -- lifecycle -----------------------------------------------------------

    def start(self, session):
        """Spawn + bootstrap the worker fleet from `session`'s catalog."""
        self._boot_session = session  # lint: unguarded-ok — set once at start(), read-only afterwards
        try:
            # lint: checkpoint-exempt — fleet bootstrap precedes any query scope: no KILL/deadline exists to observe yet
            for i in range(self.n_workers):
                self.spawn_worker(f"w{i}")
        except BaseException:
            self.stop()  # a failed start leaves no worker running
            raise
        return self

    def attach(self, session):
        """Publish this runtime on the session's (shared) catalog: every
        session over that catalog — incl. a serving tier's pool — routes
        eligible fragment queries through the cluster."""
        session.catalog.cluster_runtime = self
        return self

    def spawn_worker(self, worker_id: str) -> _WorkerHandle:
        """Spawn one worker process and bootstrap it. Also the respawn
        path: a re-used worker_id replaces the dead handle."""
        env = dict(os.environ)
        root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        proc = subprocess.Popen(
            [sys.executable, "-m", "starrocks_tpu_torch.runtime.cluster_exec",
             "--worker-id", worker_id, "--shards", str(self.shards),
             "--hb-port", str(self.monitor.port),
             "--hb-interval-s", str(self.monitor.interval_s)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True, env=env)
        try:
            port = self._read_port(proc)
            handle = _WorkerHandle(worker_id, proc, "127.0.0.1", port)
            self._bootstrap_worker(handle)
        except BaseException:
            proc.terminate()
            proc.wait(timeout=10)
            raise
        with self._lock:
            self._workers[worker_id] = handle
            CLUSTER_WORKERS.set(len(self._workers))
        return handle

    @staticmethod
    def _read_port(proc, timeout_s: float = 60.0) -> int:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError(
                    f"worker exited during spawn (rc={proc.poll()})")
            if line.startswith("SR_TPU_WORKER_PORT="):
                return int(line.strip().split("=", 1)[1])
        raise RuntimeError("worker did not report its port in time")

    def worker_device(self, worker_id: str) -> str:
        """The device worker `worker_id` runs on: on a coordinator with a
        bare `cuda`, the i-th worker spawned gets `cuda:(i % cards)`; a
        coordinator on one named card or on the CPU gives its own."""
        import torch

        with self._lock:
            dev = self.devices.get(worker_id)
            if dev is not None:
                return dev
            own = self._boot_session.device
            if own.type == "cuda" and own.index is None:
                count = torch.cuda.device_count()
                if count < 1:
                    raise RuntimeError("a cuda coordinator sees no card")
                dev = f"cuda:{len(self.devices) % count}"
            else:
                dev = str(own)
            self.devices[worker_id] = dev
            return dev

    def _bootstrap_payload(self, worker_id: str) -> dict:
        from ..sql import distributed

        sess = self._boot_session
        ddl, tables, versions = [], {}, {}
        for name in sorted(sess.catalog.tables):
            if name.startswith(("information_schema.", "__")):
                continue
            ddl.append(sess._show_create(name))
            handle = sess.catalog.get_table(name)
            tables[name] = handle.table
            versions[name] = sess.catalog.data_version(name)
        for vname in sorted(sess.catalog.views):
            ddl.append(sess._show_create(vname))
        return {
            "device": self.worker_device(worker_id),
            "ddl": ddl, "tables": tables, "versions": versions,
            "knobs": {k: config.get(k) for k in _SHIPPED_KNOBS},
            "thresholds": {
                "shard_threshold_rows": distributed.SHARD_THRESHOLD_ROWS,
                "shuffle_agg_min_groups":
                    distributed.SHUFFLE_AGG_MIN_GROUPS,
            },
        }

    def _bootstrap_worker(self, handle: _WorkerHandle):
        payload = self._bootstrap_payload(handle.worker_id)
        reply = self._request(handle, "BOOTSTRAP", payload,
                              timeout_s=max(120.0, self._timeout_s()))
        if not reply.get("ok"):
            raise RuntimeError(
                f"worker {handle.worker_id} bootstrap failed: {reply}")
        handle.synced = dict(payload["versions"])
        handle.plans = set()

    def stop(self):
        """Tear the fleet down: best-effort SHUTDOWN, then terminate."""
        with self._lock:
            workers = list(self._workers.values())
            self._workers.clear()
            CLUSTER_WORKERS.set(0)
        # lint: checkpoint-exempt — teardown path: the fleet is being destroyed and every per-worker wait is individually bounded
        for w in workers:
            try:
                self._request(w, "SHUTDOWN", None, timeout_s=2.0)
            except (OSError, _WorkerGone, WorkerQueryError):
                pass  # lint: swallow-ok — already dead is fine here
            if w.proc is not None:
                w.proc.terminate()
                try:
                    w.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    w.proc.kill()
                    w.proc.wait(timeout=10)
                if w.proc.stdout is not None:
                    w.proc.stdout.close()
        self.monitor.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- liveness ------------------------------------------------------------

    def _on_worker_down(self, worker_id: str):
        """ClusterMonitor watchdog hook (fires once per down transition);
        the optional self-healing path respawns under the SAME id, whose
        first beat flips the monitor back to ALIVE."""
        if not self.auto_respawn:
            return
        with self._lock:
            known = worker_id in self._workers
        if known:
            self.respawn_worker(worker_id)

    def respawn_worker(self, worker_id: str):
        with self._lock:
            old = self._workers.get(worker_id)
        if old is not None and old.proc is not None:
            old.proc.terminate()
            try:
                old.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                old.proc.kill()
                old.proc.wait(timeout=10)
            if old.proc.stdout is not None:
                old.proc.stdout.close()
        return self.spawn_worker(worker_id)

    def alive_workers(self) -> list:
        """Handles not currently DEAD, ordered by id (deterministic
        placement). A worker the monitor has not seen yet (still booting)
        counts as alive — its process liveness is checked too."""
        members = self.monitor.members()
        with self._lock:
            out = []
            for wid in sorted(self._workers):
                w = self._workers[wid]
                state = members.get(wid, {}).get("state")
                if state != DEAD and w.alive_process():
                    out.append(w)
            return out

    def workers(self) -> list:
        with self._lock:
            return [self._workers[w] for w in sorted(self._workers)]

    # -- exchange plane ------------------------------------------------------

    def _timeout_s(self) -> float:
        return float(config.get("cluster_exec_timeout_s"))

    def _request(self, handle: _WorkerHandle, mtype: str, payload,
                 timeout_s: float | None = None):
        """One request/reply over a fresh connection. Socket waits tick
        `lifecycle.checkpoint` (KILL/deadline stay live mid-exchange),
        probe the monitor, and enforce the fragment deadline."""
        timeout = timeout_s if timeout_s is not None else self._timeout_s()
        deadline = time.monotonic() + timeout

        def on_wait():
            lifecycle.checkpoint("cluster::recv")
            if self.monitor.members().get(
                    handle.worker_id, {}).get("state") == DEAD:
                raise _WorkerGone(handle.worker_id,
                                  "declared DEAD by heartbeat monitor")
            if time.monotonic() > deadline:
                raise _WorkerGone(
                    handle.worker_id,
                    f"no answer within {timeout:.1f}s (partitioned?)")

        try:
            with socket.create_connection(
                    (handle.host, handle.port),
                    timeout=min(timeout, 10.0)) as sock:
                sock.settimeout(0.1)
                _send_msg(sock, {"type": mtype}, payload, on_wait)
                _header, reply = _recv_msg(sock, on_wait)
                return reply
        except _WorkerGone:
            raise  # on_wait verdicts (DEAD / deadline) pass through
        except socket.timeout as e:
            raise _WorkerGone(handle.worker_id, f"timeout: {e}") from e
        except (ConnectionError, EOFError, pickle.UnpicklingError,
                OSError) as e:
            raise _WorkerGone(handle.worker_id,
                              f"{type(e).__name__}: {e}") from e

    def _sync_worker(self, handle: _WorkerHandle, tables):
        """Ship any table whose coordinator data version moved since this
        worker last saw it (DML between queries)."""
        sess = self._boot_session
        for name in tables:
            lifecycle.checkpoint("cluster::sync")
            if name.startswith(("information_schema.", "__")):
                continue
            ver = sess.catalog.data_version(name)
            if handle.synced.get(name) == ver:
                continue
            h = sess.catalog.get_table(name)
            reply = self._request(handle, "SYNC_TABLE",
                                  {"name": name, "data": h.table})
            if not reply.get("ok"):
                raise WorkerQueryError(handle.worker_id,
                                       reply.get("etype", "SyncError"),
                                       reply.get("error", str(reply)))
            handle.synced[name] = ver
            handle.plans = set()  # worker dropped its IR cache on sync

    def exec_fragment(self, plan_blob: bytes, fp: str, fid: int, bnd,
                      tables, profile=None):
        """Run one fragment on some ALIVE worker, re-placing on loss up
        to `cluster_fragment_retries` times. `bnd` are the host pytrees
        of upstream fragment outputs (coordinator-cached)."""
        fail_point("cluster::exec_fragment")
        retries = int(config.get("cluster_fragment_retries"))
        last_failed = None
        last_err = None
        for attempt in range(retries + 1):
            lifecycle.checkpoint("cluster::schedule")
            w = self._pick_worker(
                fid, exclude=(last_failed,) if last_failed else ())
            if w is None:
                last_err = last_err or "no ALIVE workers"
                time.sleep(0.05)
                continue
            if attempt > 0:
                self.retries_total += 1  # lint: unguarded-ok — stats counter: a torn read only mis-sizes one bench summary line
                RETRIES_TOTAL.inc()
                if profile is not None:
                    profile.add_counter("cluster_retries", 1)
            try:
                return self._exec_on(w, plan_blob, fp, fid, bnd, tables)
            except _WorkerGone as e:
                last_failed = e.worker_id
                last_err = e.reason
                continue
        raise WorkerLostError(last_failed or "<no-alive-worker>", fid,
                              str(last_err))

    def _exec_on(self, w: _WorkerHandle, plan_blob, fp, fid, bnd, tables):
        self._sync_worker(w, tables)
        body = {"fp": fp, "fid": fid, "bnd": bnd}
        if fp not in w.plans:
            body["plan"] = plan_blob
        reply = self._request(w, "EXEC_FRAGMENT", body)
        if reply.get("unknown_plan"):
            body["plan"] = plan_blob
            reply = self._request(w, "EXEC_FRAGMENT", body)
        if not reply.get("ok"):
            raise WorkerQueryError(w.worker_id,
                                   reply.get("etype", "WorkerError"),
                                   reply.get("error", str(reply)))
        w.plans.add(fp)
        self.fragments_total += 1  # lint: unguarded-ok — stats counter: a torn read only mis-sizes one bench summary line
        FRAGMENTS_TOTAL.inc()
        return reply["out"]

    def _pick_worker(self, fid: int, exclude=()):
        """Deterministic placement (fid round-robins the sorted ALIVE
        set); `exclude` skips the worker that just failed this fragment
        when an alternative exists."""
        alive = self.alive_workers()
        if not alive:
            return None
        pool = [w for w in alive if w.worker_id not in exclude] or alive
        return pool[fid % len(pool)]

    # -- chaos hooks ---------------------------------------------------------

    def inject_fault(self, worker_id: str, action: str, seconds: float,
                     times: int = 1):
        """Arm a delay/blackhole fault on one worker's NEXT EXEC_FRAGMENT
        (the network-partition chaos family: tools/chaos_fuzz.py)."""
        with self._lock:
            w = self._workers.get(worker_id)
        if w is None:
            raise KeyError(worker_id)
        return self._request(w, "CHAOS", {"action": action,
                                          "seconds": seconds,
                                          "times": times})

    def kill_worker(self, worker_id: str):
        """SIGKILL a worker process mid-whatever (the process-kill chaos
        family). The heartbeat plane notices; queries re-place."""
        with self._lock:
            w = self._workers.get(worker_id)
        if w is None or w.proc is None:
            raise KeyError(worker_id)
        w.proc.kill()
        w.proc.wait(timeout=10)

    def stats(self) -> dict:
        members = self.monitor.members()
        with self._lock:
            n = len(self._workers)
            devices = dict(self.devices)
        return {
            "workers": n,
            "alive": sum(1 for m in members.values()
                         if m["state"] != DEAD),
            "retries_total": self.retries_total,
            "fragments_total": self.fragments_total,
            "devices": devices,
        }


def plan_fingerprint(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()[:24]


if __name__ == "__main__":
    sys.exit(worker_main())
