"""Port counterpart of tests/test_concur_check.py: the static
concurrency-contract analyzer and the boundary manifest, run over
starrocks_tpu_torch.

Golden BAD fixtures prove each checker rejects what it exists to reject —
a seeded lock-order inversion, an unguarded access to a `guarded_by`
field, a forbidden/undeclared import — and twin GOOD fixtures prove the
escape hatches (`with self._lock`, `# lint: holds`, `# lint:
unguarded-ok`, manifest allow prefixes) pass clean. Then the real
package: `starrocks_tpu_torch/` must be strict-clean (zero errors and
zero warns) under both analyzers.
"""

from __future__ import annotations

import pytest

from starrocks_tpu_torch.analysis import astwalk, boundary_check, concur_check


@pytest.fixture(scope="module", autouse=True)
def _lock_witness_acyclic():
    """Teardown gate of the port's runtime lock-witness: the order graph
    of every lock this module's tests took has no cycle."""
    yield
    from starrocks_tpu_torch import lockdep as _lockdep

    cycles = _lockdep.WITNESS.order_cycles()
    assert not cycles, _lockdep.WITNESS.render(cycles)


def _rules(rep, severity=None):
    fs = rep.findings if hasattr(rep, "findings") else rep
    return [f.rule for f in fs if severity in (None, f.severity)]


# --- lock-order graph ----------------------------------------------------------

INVERSION = '''
import threading

class A:
    def __init__(self):
        self._la = threading.Lock()

    def m(self):
        with self._la:
            b.n()

    def locked_leaf(self):
        with self._la:
            pass

class B:
    def __init__(self):
        self._lb = threading.Lock()

    def n(self):
        with self._lb:
            a.locked_leaf()

a = A()
b = B()
'''


def test_lock_order_inversion_rejected():
    rep = concur_check.check_fixture(INVERSION)
    cycles = [f for f in rep.findings if f.rule == "lock-order-cycle"]
    assert len(cycles) == 1 and cycles[0].severity == "error"
    # the finding names both locks and both witnessing sites
    assert "fixture.A._la" in cycles[0].message
    assert "fixture.B._lb" in cycles[0].message
    assert "fixture.py:" in cycles[0].message


def test_one_way_ordering_clean():
    # same shape, but B.n does NOT call back into A: a DAG, no finding
    src = INVERSION.replace("            a.locked_leaf()\n", "            pass\n")
    rep = concur_check.check_fixture(src)
    assert "lock-order-cycle" not in _rules(rep)
    assert rep.stats["edges"] == 1  # A._la -> B._lb recorded


def test_cross_object_instance_resolution():
    # the MemoryAccountant.charge shape: a module FUNCTION calls a
    # module-level instance's method; holding another lock around that
    # function must produce the cross-object edge
    src = '''
import threading

class Accountant:
    def __init__(self):
        self._lock = threading.Lock()

    def charge(self):
        with self._lock:
            pass

ACC = Accountant()

def account():
    ACC.charge()

class Exec:
    def __init__(self):
        self._mu = threading.Lock()

    def step(self):
        with self._mu:
            account()
'''
    rep = concur_check.check_fixture(src)
    assert rep.stats["edges"] == 1
    assert not rep.errors


def test_factory_bound_local_resolution():
    # round-12 extension: a LOCAL bound from a known factory
    # (`c = reg.counter(...)`) resolves to the factory's return class, so
    # calling its locking method while holding another lock records the
    # cross-object edge — previously locals were invisible to the graph
    src = '''
import threading

class Counter:
    def __init__(self):
        self._lock = threading.Lock()

    def inc(self):
        with self._lock:
            pass

class MetricRegistry:
    def counter(self, name):
        return Counter()

reg = MetricRegistry()

class Exec:
    def __init__(self):
        self._mu = threading.Lock()

    def step(self):
        c = reg.counter("x")
        with self._mu:
            c.inc()
'''
    rep = concur_check.check_fixture(src)
    assert not rep.errors
    assert rep.stats["edges"] == 1  # Exec._mu -> Counter._lock witnessed


def test_factory_local_chain_through_constructor():
    # two-hop fixpoint: local registry constructed locally, then a local
    # counter minted from it — still resolves
    src = '''
import threading

class Counter:
    def __init__(self):
        self._lock = threading.Lock()

    def inc(self):
        with self._lock:
            pass

class MetricRegistry:
    def counter(self, name):
        return Counter()

class Exec:
    def __init__(self):
        self._mu = threading.Lock()

    def step(self):
        reg = MetricRegistry()
        c = reg.counter("x")
        with self._mu:
            with c._lock:
                pass
'''
    rep = concur_check.check_fixture(src)
    assert not rep.errors
    assert rep.stats["edges"] == 1


def test_direct_self_nest_nonreentrant_rejected():
    src = '''
import threading

class C:
    def __init__(self):
        self._mu = threading.Lock()

    def bad(self):
        with self._mu:
            with self._mu:
                pass
'''
    rep = concur_check.check_fixture(src)
    assert "self-deadlock" in _rules(rep, "error")
    # RLock twin is legal
    rep2 = concur_check.check_fixture(src.replace("Lock()", "RLock()"))
    assert "self-deadlock" not in _rules(rep2)


# --- guarded_by discipline -----------------------------------------------------

GUARDED = '''
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.state = {}  # guarded_by: _lock

    def good(self):
        with self._lock:
            self.state["k"] = 1

    def helper(self):  # lint: holds _lock
        return len(self.state)

    def bad(self):
        return self.state.get("k")

    def closure_trap(self):
        with self._lock:
            def later():
                return self.state
            return later

    def reviewed(self):
        return self.state  # lint: unguarded-ok
'''


def test_guarded_by_violations():
    rep = concur_check.check_fixture(GUARDED)
    errs = [f for f in rep.errors if f.rule == "guarded-by"]
    # exactly two: `bad` (no lock) and the closure body (runs after the
    # with-block exits — lexical nesting does not mean held-at-call-time)
    assert len(errs) == 2
    lines = sorted(int(f.where.rsplit(":", 1)[1]) for f in errs)
    assert "bad" in GUARDED.splitlines()[lines[0] - 2]  # def line above
    # good/helper/reviewed produce nothing
    assert all("good" not in f.message and "helper" not in f.message
               and "reviewed" not in f.message for f in errs)


def test_guarded_by_unknown_lock_rejected():
    src = '''
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.x = 0  # guarded_by: _nope
'''
    rep = concur_check.check_fixture(src)
    assert "guarded-by-unknown-lock" in _rules(rep, "error")


def test_unannotated_mutable_attr_warns_and_suppression():
    src = '''
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.table = {}
        self.reviewed = {}  # lint: unguarded-ok
        self.scalar_set_once = 0
'''
    rep = concur_check.check_fixture(src)
    warns = [f for f in rep.warnings
             if f.rule == "unannotated-mutable-attr"]
    assert len(warns) == 1 and "C.table" in warns[0].message
    # scalar assigned only in __init__ with an immutable RHS: not flagged


def test_lockdep_factories_inventoried():
    src = '''
from starrocks_tpu_torch import lockdep

class C:
    def __init__(self):
        self._lock = lockdep.rlock("C._lock")
        self.x = 0  # guarded_by: _lock

    def bad(self):
        self.x += 1
'''
    rep = concur_check.check_fixture(src)
    assert rep.stats["locks"] == 1
    assert "guarded-by" in _rules(rep, "error")


def test_inherited_lock_and_guard():
    # the Counter/Gauge shape: subclass methods touch base-guarded state
    src = '''
import threading

class Base:
    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0  # guarded_by: _lock

class Sub(Base):
    def good(self):
        with self._lock:
            self._v = 2

    def bad(self):
        self._v = 3
'''
    rep = concur_check.check_fixture(src)
    errs = [f for f in rep.errors if f.rule == "guarded-by"]
    assert len(errs) == 1 and "Sub.bad" in errs[0].message


# --- module-boundary manifest --------------------------------------------------

_MANIFEST = {
    "units": {
        "ops": {"allow": ["ops", "column", "runtime.config"],
                "forbid": ["runtime"]},
        "column": {"allow": ["column"]},
        "runtime": {"allow": ["*"]},
    },
}


def _fixture_sources(*pairs):
    # target stubs must exist as modules for `from ..x import y` to
    # resolve as a submodule import
    stubs = [astwalk.parse_fixture("", rel) for rel in (
        "starrocks_tpu_torch/runtime/__init__.py",
        "starrocks_tpu_torch/runtime/config.py",
        "starrocks_tpu_torch/runtime/lifecycle.py",
        "starrocks_tpu_torch/column/__init__.py",
        "starrocks_tpu_torch/ops/__init__.py",
    )]
    return stubs + [astwalk.parse_fixture(src, rel) for rel, src in pairs]


def test_forbidden_import_rejected():
    srcs = _fixture_sources(
        ("starrocks_tpu_torch/ops/bad.py",
         "from ..runtime import lifecycle\n"))
    fs = boundary_check.check_imports(_MANIFEST, srcs)
    assert any(f.rule == "forbidden-import" and "runtime.lifecycle"
               in f.message for f in fs)


def test_allow_exception_beats_forbid_prefix():
    # ops may import runtime.config even though runtime/ is forbidden:
    # longest prefix wins: the forbid-with-exception contract shape
    srcs = _fixture_sources(
        ("starrocks_tpu_torch/ops/good.py",
         "from ..runtime.config import config\nfrom ..column import x\n"))
    fs = boundary_check.check_imports(_MANIFEST, srcs)
    assert [str(f) for f in fs if f.severity == "error"] == []


def test_undeclared_import_rejected():
    manifest = {"units": {"column": {"allow": ["column"]},
                          "ops": {"allow": ["ops"]},
                          "runtime": {"allow": ["*"]}}}
    srcs = _fixture_sources(
        ("starrocks_tpu_torch/column/sneaky.py", "from ..ops import x\n"))
    fs = boundary_check.check_imports(manifest, srcs)
    assert any(f.rule == "undeclared-import" for f in fs)


def test_unit_missing_from_manifest_rejected():
    srcs = _fixture_sources(
        ("starrocks_tpu_torch/newpkg/mod.py", "import os\n"))
    fs = boundary_check.check_imports(_MANIFEST, srcs)
    assert any(f.rule == "unit-missing" for f in fs)


def test_module_rule_override_tighter_than_unit():
    manifest = {
        "units": {"ops": {"allow": ["ops", "column"]},
                  "column": {"allow": ["column"]},
                  "runtime": {"allow": ["*"]}},
        "module_rules": {"ops/pinned.py": {"allow": []}},
    }
    srcs = _fixture_sources(
        ("starrocks_tpu_torch/ops/pinned.py", "from ..column import x\n"))
    fs = boundary_check.check_imports(manifest, srcs)
    assert any(f.rule == "undeclared-import" for f in fs)


def test_governed_external_rejected_outside_allow_list():
    # sockets are service-layer-only; a storage module opening one fails
    manifest = {
        "external_governed": ["torch", "socket"],
        "units": {"ops": {"allow": ["ops"], "external": ["torch"]},
                  "column": {"allow": ["column"], "external": ["torch"]},
                  "runtime": {"allow": ["*"], "external": ["torch", "socket"]}},
    }
    srcs = _fixture_sources(
        ("starrocks_tpu_torch/ops/leaky.py",
         "def f():\n    import socket\n    return socket.gethostname()\n"))
    fs = boundary_check.check_imports(manifest, srcs)
    assert any(f.rule == "external-import" and "'socket'" in f.message
               for f in fs), fs
    # torch is allow-listed for ops: no finding
    srcs = _fixture_sources(
        ("starrocks_tpu_torch/ops/fine.py", "from torch.nn import functional\n"))
    assert not boundary_check.check_imports(manifest, srcs)


def test_real_manifest_governs_externals():
    m = boundary_check.load_manifest()
    assert "socket" in m["external_governed"]
    assert "torch" in m["external_governed"]
    # sockets are granted ONLY via service-module pins, never unit-wide
    for unit, rule in m["units"].items():
        assert "socket" not in rule.get("external", []), unit
    assert "socket" in m["module_rules"]["runtime/mysql_service.py"][
        "external"]
    # the static gates stay stdlib-only, externally too
    assert m["module_rules"]["analysis/boundary_check.py"]["external"] == []


# --- the real package must hold its own contract -------------------------------

def test_package_concur_strict_clean():
    rep = concur_check.check_package()
    assert rep.errors == [], "\n".join(str(f) for f in rep.errors)
    # no warn either: every mutable field of a lock-owning class is
    # guarded or carries its reviewed reason
    assert rep.warnings == [], "\n".join(str(f) for f in rep.warnings)
    # sanity: the inventory actually sees the engine's locks and the
    # cross-object edges (QueryCache/Workgroup -> metrics, journal ->
    # failpoint registry)
    assert rep.stats["locks"] >= 10
    assert rep.stats["guarded_attrs"] >= 15
    assert rep.stats["edges"] >= 3


def test_package_boundary_manifest_clean():
    fs = boundary_check.check_package()
    assert [str(f) for f in fs] == []


def test_manifest_pins_static_analyzers_to_zero_deps():
    m = boundary_check.load_manifest()
    for mod in ("analysis/astwalk.py", "analysis/concur_check.py",
                "analysis/boundary_check.py"):
        rule = m["module_rules"][mod]
        assert set(rule["allow"]) <= {"analysis.astwalk"}
