"""Port counterpart of tests/test_effects_check.py: the interprocedural
effect checker over starrocks_tpu_torch, its device-wait class re-derived
for torch (torch.cuda.synchronize, an Event's synchronize, and .item(),
.tolist(), .cpu(), .numpy(), .to("cpu") of a tensor).

Golden BAD fixtures prove each of the four contracts rejects what it
exists to reject — an acquire a raise can leak, a blocking loop a KILL
cannot land in, expensive work under a lockdep lock, a thread without a
daemon flag or a stop — and twin GOOD fixtures prove the recognized safe
shapes (with-items, assign-then-try-finally, the gate form, arm/disarm
pairing, transitive checkpoints, thread-target loops) pass clean. Each
suppression annotation is exercised with and without a reason (a bare
tag is the `--strict-warn` ratchet's warn). Then the real package:
`starrocks_tpu_torch/` must be strict-clean — zero errors AND zero warns.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from starrocks_tpu_torch.analysis import effects_check


@pytest.fixture(scope="module", autouse=True)
def _lock_witness_acyclic():
    """Teardown gate of the port's runtime lock-witness: the order graph
    of every lock this module's tests took has no cycle."""
    yield
    from starrocks_tpu_torch import lockdep as _lockdep

    cycles = _lockdep.WITNESS.order_cycles()
    assert not cycles, _lockdep.WITNESS.render(cycles)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rules(rep, severity=None):
    return [f.rule for f in rep.findings
            if severity in (None, f.severity)]


def _one(rep, rule):
    hits = [f for f in rep.findings if f.rule == rule]
    assert len(hits) == 1, f"expected one {rule}, got {rep.findings}"
    return hits[0]


# === contract 1: exception-safe acquire =======================================

C1_BAD_LOCK = '''
import threading

class S:
    def __init__(self):
        self._lock = threading.Lock()

    def grab(self):
        self._lock.acquire()
        do_work()
        self._lock.release()
'''


def test_unprotected_lock_acquire_rejected():
    f = _one(effects_check.check_fixture(C1_BAD_LOCK),
             "unprotected-acquire")
    assert f.severity == "error"
    assert f.where == "starrocks_tpu_torch/fixture.py:9"  # the acquire site
    assert "lock" in f.message and "try-finally" in f.message


C1_BAD_SOCKET = '''
import http.client

class Beater:
    def beat(self):
        conn = http.client.HTTPConnection("coord", 80)
        conn.request("GET", "/")   # an OSError here leaks the socket
        conn.close()
'''

C1_GOOD_SOCKET = '''
import http.client

class Beater:
    def beat(self):
        conn = http.client.HTTPConnection("coord", 80)
        try:
            conn.request("GET", "/")
        finally:
            conn.close()
'''


def test_socket_constructor_is_an_acquire():
    f = _one(effects_check.check_fixture(C1_BAD_SOCKET),
             "unprotected-acquire")
    assert "socket" in f.message
    assert _rules(effects_check.check_fixture(C1_GOOD_SOCKET)) == []


C1_BAD_SLOT = '''
class M:
    def admit(self, g):
        return lambda: None

    def admission(self, g):
        release = self.admit(g)
        register(release)     # a raise HERE leaks the slot
        try:
            return release
        finally:
            release()
'''

C1_GOOD_SLOT = '''
class M:
    def admit(self, g):
        return lambda: None

    def admission(self, g):
        release = self.admit(g)
        try:
            register(release)
            return release
        finally:
            release()
'''

C1_GOOD_GATE = '''
class T:
    def try_shared(self, tabs):
        return True

    def fast(self, gate, tabs):
        if not gate.try_shared(tabs):
            return None
        try:
            return run()
        finally:
            gate.release_shared(tabs)
'''


def test_slot_acquire_needs_immediate_try_finally():
    f = _one(effects_check.check_fixture(C1_BAD_SLOT),
             "unprotected-acquire")
    assert "slot" in f.message
    assert _rules(effects_check.check_fixture(C1_GOOD_SLOT)) == []
    # the gate form: `if not gate.try_shared(): return MISS` + try-finally
    assert _rules(effects_check.check_fixture(C1_GOOD_GATE)) == []


C1_BAD_ARM = '''
from starrocks_tpu_torch.runtime import failpoint

def inject(name):
    failpoint.arm(name)   # armed forever: no disarm on any path
    run()
'''

C1_GOOD_ARM = '''
from starrocks_tpu_torch.runtime import failpoint

def inject(name):
    failpoint.arm(name)
    try:
        run()
    finally:
        failpoint.disarm(name)
'''


def test_failpoint_arm_must_pair_with_disarm():
    f = _one(effects_check.check_fixture(C1_BAD_ARM),
             "unprotected-acquire")
    assert "disarm" in f.message
    assert _rules(effects_check.check_fixture(C1_GOOD_ARM)) == []


def test_with_item_open_is_protected():
    rep = effects_check.check_fixture('''
def read(p):
    with open(p) as f:
        return f.read()
''')
    assert _rules(rep) == []


# === contract 2: checkpoint density ==========================================

C2_BAD = '''
import time

class Pool:
    def drain(self):
        while pending():
            time.sleep(0.05)
'''

C2_GOOD_DIRECT = '''
import time

class Pool:
    def drain(self, ctx):
        while pending():
            ctx.checkpoint("drain")
            time.sleep(0.05)
'''

C2_GOOD_TRANSITIVE = '''
import time

class Pool:
    def _step(self, ctx):
        ctx.checkpoint("step")
        time.sleep(0.05)

    def drain(self, ctx):
        while pending():
            self._step(ctx)
'''

C2_GOOD_THREAD_TARGET = '''
import threading
import time

class Sampler:
    def start(self):
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            time.sleep(0.05)

    def stop(self):
        pass
'''


def test_checkpoint_free_blocking_loop_rejected():
    f = _one(effects_check.check_fixture(C2_BAD),
             "checkpoint-free-blocking-loop")
    assert f.severity == "error"
    assert f.where == "starrocks_tpu_torch/fixture.py:6"  # the loop
    assert "sleep" in f.message and "checkpoint" in f.message


def test_checkpointed_loops_pass_direct_and_transitive():
    assert _rules(effects_check.check_fixture(C2_GOOD_DIRECT)) == []
    assert _rules(effects_check.check_fixture(C2_GOOD_TRANSITIVE)) == []


def test_thread_target_loops_exempt():
    # a daemon service loop is not query context: no checkpoint needed
    assert _rules(effects_check.check_fixture(C2_GOOD_THREAD_TARGET)) == []


# === contract 3: no blocking under lock ======================================

C3_BAD = '''
from starrocks_tpu_torch import lockdep

class Cache:
    def __init__(self):
        self._lock = lockdep.lock("Cache._lock")

    def build(self, fn, x):
        with self._lock:
            return fn.lower(x).compile()
'''

C3_GOOD = '''
from starrocks_tpu_torch import lockdep

class Cache:
    def __init__(self):
        self._lock = lockdep.lock("Cache._lock")

    def build(self, fn, x):
        comp = fn.lower(x).compile()   # expensive work OUTSIDE the lock
        with self._lock:
            self._slot = comp
        return comp
'''

C3_BAD_TRANSITIVE = '''
import time
from starrocks_tpu_torch import lockdep

class Store:
    def __init__(self):
        self._lock = lockdep.lock("Store._lock")

    def _settle(self):
        time.sleep(0.1)

    def mutate(self):
        with self._lock:
            self._settle()
'''

C3_GOOD_WAIT = '''
from starrocks_tpu_torch import lockdep

class Q:
    def __init__(self):
        self._lock = lockdep.condition("Q._lock")

    def pop(self):
        with self._lock:
            while not self._items:
                self._lock.wait(timeout=0.5)
'''


def test_compile_under_lock_rejected():
    f = _one(effects_check.check_fixture(C3_BAD), "blocking-under-lock")
    assert f.severity == "error"
    assert f.where == "starrocks_tpu_torch/fixture.py:10"  # the blocking site
    assert "compile" in f.message and "Cache._lock" in f.message
    assert _rules(effects_check.check_fixture(C3_GOOD)) == []


def test_blocking_under_lock_found_through_calls():
    f = _one(effects_check.check_fixture(C3_BAD_TRANSITIVE),
             "blocking-under-lock")
    assert "sleep" in f.message and "_settle" in f.message


def test_condition_wait_under_its_lock_allowed():
    # Condition.wait RELEASES the lock while parked: the standard
    # wait-loop is not a blocking-under-lock violation (C2 still applies
    # to loops, but this loop blocks only on "wait")
    rep = effects_check.check_fixture(C3_GOOD_WAIT)
    assert "blocking-under-lock" not in _rules(rep)


# === contract 4: daemon-thread lifecycle =====================================

C4_BAD = '''
import threading

class Svc:
    def start(self):
        self._t = threading.Thread(target=self._run)
        self._t.start()

    def _run(self):
        pass
'''

C4_GOOD = '''
import threading

class Svc:
    def ensure_started(self):
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        pass

    def stop(self):
        self._t.join(timeout=2)
'''


def test_non_daemon_thread_and_missing_stop_rejected():
    rep = effects_check.check_fixture(C4_BAD)
    rules = _rules(rep, "error")
    assert "non-daemon-thread" in rules and "thread-without-stop" in rules
    assert all(f.where == "starrocks_tpu_torch/fixture.py:6"
               for f in rep.findings)
    assert _rules(effects_check.check_fixture(C4_GOOD)) == []


# === contract 4b: subprocess lifecycle =======================================

C4_PROC_BAD = '''
import subprocess

class Fleet:
    def spawn(self):
        self._p = subprocess.Popen(["sleep", "60"])
'''

C4_PROC_GOOD = '''
import subprocess

class Fleet:
    def spawn(self):
        self._p = subprocess.Popen(["sleep", "60"])

    def stop(self):
        self._p.terminate()
        self._p.wait(timeout=5)
'''


def test_popen_without_owner_stop_rejected():
    rep = effects_check.check_fixture(C4_PROC_BAD)
    assert _one(rep, "proc-without-stop").severity == "error"
    assert _rules(effects_check.check_fixture(C4_PROC_GOOD)) == []
    assert effects_check.check_fixture(C4_PROC_GOOD).stats["procs"] == 1


def test_popen_counts_as_proc_acquire_site():
    from starrocks_tpu_torch.analysis import astwalk

    sites = effects_check.acquire_sites(
        [astwalk.parse_fixture(C4_PROC_GOOD, "starrocks_tpu_torch/fixture.py")])
    procs = [s for s in sites if s.kind == "proc"]
    assert len(procs) == 1 and procs[0].func.endswith(".spawn")
    assert procs[0].line == 6
    # ownership (stop/terminate on the owner class) is the guard for a
    # child process, not a with-block — no unprotected-acquire finding
    assert "unprotected-acquire" not in _rules(
        effects_check.check_fixture(C4_PROC_GOOD))


# === suppression annotations =================================================

def test_blocking_ok_with_reason_suppresses_and_counts():
    rep = effects_check.check_fixture(C3_BAD.replace(
        "return fn.lower(x).compile()",
        "return fn.lower(x).compile()  "
        "# lint: blocking-ok — warm-path recompile is bounded and rare"))
    assert _rules(rep) == []
    assert rep.stats["suppressions"] == 1
    assert rep.stats["suppressions_unexplained"] == 0


def test_blocking_ok_without_reason_warns():
    rep = effects_check.check_fixture(C3_BAD.replace(
        "return fn.lower(x).compile()",
        "return fn.lower(x).compile()  # lint: blocking-ok"))
    assert _rules(rep, "error") == []          # still suppresses...
    assert _rules(rep, "warn") == ["suppression-missing-reason"]
    assert rep.stats["suppressions_unexplained"] == 1


def test_checkpoint_exempt_with_reason_suppresses():
    rep = effects_check.check_fixture(C2_BAD.replace(
        "while pending():",
        "while pending():  # lint: checkpoint-exempt — reaper loop IS "
        "the enforcement"))
    assert _rules(rep) == []
    assert rep.stats["suppressions"] == 1


def test_checkpoint_exempt_without_reason_warns():
    rep = effects_check.check_fixture(C2_BAD.replace(
        "while pending():",
        "while pending():  # lint: checkpoint-exempt"))
    assert _rules(rep, "error") == []
    assert _rules(rep, "warn") == ["suppression-missing-reason"]


# === the real package ========================================================

def test_package_effects_strict_clean():
    """Strict over the port: zero errors AND zero warns — every reviewed
    exception carries a reason."""
    rep = effects_check.check_package()
    errors = [f for f in rep.findings if f.severity == "error"]
    warns = [f for f in rep.findings if f.severity == "warn"]
    assert errors == [], "\n".join(str(f) for f in errors)
    assert warns == [], "\n".join(str(f) for f in warns)
    assert rep.stats["suppressions_unexplained"] == 0
    # the census is real: the runtime DOES carry reviewed exceptions
    assert rep.stats["suppressions"] >= 5
    assert rep.stats["acquire_sites"] >= 20
    assert rep.stats["threads"] >= 5


def test_acquire_sites_enumeration_for_chaos_cross_check():
    from starrocks_tpu_torch.analysis import astwalk

    sites = effects_check.acquire_sites(astwalk.package_sources())
    kinds = {s.kind for s in sites}
    # the kinds chaos_fuzz cross-checks against failpoint coverage (no
    # raw "lock" sites: every package lock acquire is a `with` — which
    # is the contract)
    assert {"file", "slot", "failpoint", "socket"} <= kinds
    assert any(s.rel.endswith("runtime/workgroup.py") and s.kind == "slot"
               for s in sites)
    assert all(s.line > 0 and s.func and s.module for s in sites)


def test_analyzers_run_standalone_and_report_machine_readable():
    """The analyzers load by file path without importing the package (so
    without torch) and their findings serialize to JSON."""
    code = (
        "import importlib.util, json, sys\n"
        "d = sys.argv[1]\n"
        "def load(n):\n"
        "    spec = importlib.util.spec_from_file_location('sr_' + n, d + '/' + n + '.py')\n"
        "    m = importlib.util.module_from_spec(spec); sys.modules['sr_' + n] = m\n"
        "    spec.loader.exec_module(m); return m\n"
        "load('astwalk'); cc = load('concur_check'); ec = load('effects_check')\n"
        "r = ec.check_package(); c = cc.check_package()\n"
        "print(json.dumps({'torch': 'torch' in sys.modules,\n"
        "    'findings': [str(f) for f in r.findings + c.findings],\n"
        "    'functions': r.stats.get('functions', 0)}))\n")
    out = subprocess.run(
        [sys.executable, "-c", code,
         os.path.join(REPO, "starrocks_tpu_torch", "analysis")],
        capture_output=True, text=True, check=False)
    assert out.returncode == 0, out.stdout + out.stderr
    payload = json.loads(out.stdout)
    assert payload["torch"] is False
    assert payload["findings"] == []
    assert payload["functions"] > 1000


def test_manifest_pins_effects_check_to_analysis_only():
    """Satellite: the analyzer must stay loadable without torch — its
    module_rule allows only the shared walk and the resolver it reuses."""
    with open(os.path.join(REPO, "starrocks_tpu_torch",
                           "module_boundary_manifest.json")) as f:
        manifest = json.load(f)
    rule = manifest["module_rules"]["analysis/effects_check.py"]
    assert set(rule["allow"]) == {"analysis.astwalk",
                                  "analysis.concur_check"}
    assert rule.get("external", []) == []


# === the port's device-wait class ============================================

DEVICE_UNDER_LOCK = '''
import torch
from starrocks_tpu_torch import lockdep

class Cache:
    def __init__(self):
        self._lock = lockdep.lock("Cache._lock")

    def read(self, t):
        with self._lock:
            {wait}
'''


@pytest.mark.parametrize("wait", [
    "torch.cuda.synchronize()", "self._event.synchronize()",
    "return t.sum().item()", "return t.tolist()", "return t.cpu()",
    "return t.numpy()", "return t.to('cpu')",
    "return t.to(device='cpu')"])
def test_device_wait_under_lock_rejected(wait):
    f = _one(effects_check.check_fixture(DEVICE_UNDER_LOCK.format(wait=wait)),
             "blocking-under-lock")
    assert "device" in f.message and "Cache._lock" in f.message


@pytest.mark.parametrize("host", [
    "return np.asarray(t).tolist()", "return np.unique(t)[0].item()",
    "return t.to(torch.float64)", "return t.to('cuda')"])
def test_numpy_values_and_device_copies_are_not_waits(host):
    src = "import numpy as np\n" + DEVICE_UNDER_LOCK.format(wait=host)
    assert "blocking-under-lock" not in _rules(effects_check.check_fixture(src))


DEVICE_LOOP = '''
import torch

def total(chunks):
    out = 0
    for c in chunks:
        out += c.sum().item()
    return out
'''


def test_device_wait_loop_needs_a_checkpoint():
    f = _one(effects_check.check_fixture(DEVICE_LOOP),
             "checkpoint-free-blocking-loop")
    assert "device" in f.message and ".item()" in f.message
    fixed = DEVICE_LOOP.replace(
        "        out += c.sum().item()",
        "        lifecycle.checkpoint('sum')\n        out += c.sum().item()")
    fixed = "from ..runtime import lifecycle\n" + fixed
    assert "checkpoint-free-blocking-loop" not in _rules(
        effects_check.check_fixture(fixed))
