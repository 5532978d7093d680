"""Static concurrency-contract analyzer: lock inventory, lock-order
graph, and `# guarded_by:` discipline over starrocks_tpu_torch/.

Reference behavior: the reference encodes structural contracts as
machine-checked artifacts (be/module_boundary_manifest.json) and guards
shared BE state with annotated mutexes reviewed by convention; this pass
makes the convention mechanical, as the static half of the concurrency
contract (the runtime half is the lockdep witness validating the model
against real interleavings):

1. **Lock inventory** — every `threading.Lock/RLock/Condition` or
   `lockdep.lock/rlock/condition` assigned to a `self.<attr>` field is a
   lock *class* (all instances of `QueryCache._lock` are one node).

2. **Lock-acquisition graph** — for every method/function, the locks it
   may acquire (directly via `with self._lock:` or transitively through
   resolved calls: `self.m()`, module functions, and module-level
   instances like `ACCOUNTANT.charge(...)` or `QCACHE_HITS.inc()` — the
   cross-object edges). Acquiring B while A is lexically held records
   edge A->B; a cycle (strongly-connected component) is a potential
   deadlock and fails strict. Lexically nesting a non-reentrant Lock
   under itself is a certain self-deadlock.

3. **guarded_by discipline** — a field annotated
   ``self.x = ...  # guarded_by: _lock`` may only be read/written inside
   a `with self._lock:` block, from a method whose def line carries
   ``# lint: holds _lock`` (a documented called-with-lock-held helper),
   or from `__init__` (construction precedes sharing). Violations are
   strict-fatal. Unannotated mutable fields on lock-owning classes are
   WARN findings — the coverage ratchet `bench.py` tracks as
   `concur_findings`; ``# lint: unguarded-ok`` (same or preceding line)
   documents a reviewed deliberately-unguarded field.

Scope and honesty: resolution is name-based and intra-package — calls
through locals, dynamic dispatch, and containers are not followed, so the
graph is an under-approximation (it can miss edges, not invent them) and
guard checking is lexical (a closure created under a lock but called
later is treated as NOT holding it, which is the safe direction). Direct
field access from OUTSIDE the owning class is invisible here — keep
cross-object state behind methods.

Loadable standalone (a gate may path-load it so that it never imports
torch via the package __init__); imports nothing from the package
but astwalk.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

try:  # normal package import
    from . import astwalk
except ImportError:  # loaded standalone by file path (tools/ gates)
    import importlib.util as _ilu
    import sys as _sys

    astwalk = _sys.modules.get("sr_astwalk")
    if astwalk is None:
        _spec = _ilu.spec_from_file_location(
            "sr_astwalk",
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "astwalk.py"))
        astwalk = _ilu.module_from_spec(_spec)
        _spec.loader.exec_module(astwalk)
        _sys.modules["sr_astwalk"] = astwalk


GUARDED_RE = re.compile(r"#\s*guarded_by:\s*(\w+)")
HOLDS_RE = re.compile(r"#\s*lint:\s*holds\s+(\w+(?:\s*,\s*\w+)*)")
UNGUARDED_OK = "lint: unguarded-ok"

# factory-call attr -> lock kind ("lock" is non-reentrant)
_LOCK_CALLS = {
    ("threading", "Lock"): "lock",
    ("threading", "RLock"): "rlock",
    ("threading", "Condition"): "condition",
    ("lockdep", "lock"): "lock",
    ("lockdep", "rlock"): "rlock",
    ("lockdep", "condition"): "condition",
}
_REENTRANT = {"rlock", "condition"}

# known constructor-like factory methods: (class simple name, method) ->
# simple name of the returned class (same module as the factory class)
_FACTORY_RETURNS = {
    ("MetricRegistry", "counter"): "Counter",
    ("MetricRegistry", "gauge"): "Gauge",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    severity: str    # error | warn
    rule: str        # kebab-case rule id
    where: str       # rel:line
    message: str

    def __str__(self):
        return f"{self.where}: [{self.rule}] {self.severity}: {self.message}"


@dataclasses.dataclass
class ClassInfo:
    mod: str                      # dotted module, e.g. "runtime.metrics"
    name: str
    rel: str
    node: ast.ClassDef
    bases: list
    locks: dict = dataclasses.field(default_factory=dict)    # attr -> kind
    lock_lines: dict = dataclasses.field(default_factory=dict)
    guarded: dict = dataclasses.field(default_factory=dict)  # attr -> lock
    methods: dict = dataclasses.field(default_factory=dict)

    @property
    def qual(self):
        return f"{self.mod}.{self.name}" if self.mod else self.name


@dataclasses.dataclass
class ModuleInfo:
    ms: object
    classes: dict = dataclasses.field(default_factory=dict)
    functions: dict = dataclasses.field(default_factory=dict)
    instances: dict = dataclasses.field(default_factory=dict)  # name -> qual
    imports: dict = dataclasses.field(default_factory=dict)
    # local name -> ("module", dotted) | ("symbol", mod, name) | ("ext", top)


@dataclasses.dataclass
class Report:
    findings: list
    stats: dict

    @property
    def errors(self):
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self):
        return [f for f in self.findings if f.severity == "warn"]


def _is_self(node) -> bool:
    return isinstance(node, ast.Name) and node.id == "self"


class _Index:
    """Package-wide name index: classes, module functions, module-level
    instances, and per-module import aliases."""

    def __init__(self, sources):
        self.modules: dict = {}
        self.mod_names = astwalk.module_names(sources)
        self.findings: list = []
        for ms in sources:
            self.modules[ms.dotted] = self._collect_module(ms)
        self._resolve_instances()
        self.class_by_qual = {
            ci.qual: ci
            for mi in self.modules.values() for ci in mi.classes.values()
        }

    # --- collection -----------------------------------------------------------
    def _collect_module(self, ms) -> ModuleInfo:
        mi = ModuleInfo(ms=ms)
        if os.path.basename(ms.rel) == "__init__.py":
            pkg = ms.dotted
        else:
            pkg = ms.dotted.rsplit(".", 1)[0] if "." in ms.dotted else ""
        for node in ast.walk(ms.tree):
            if isinstance(node, ast.ImportFrom):
                self._collect_import_from(mi, node, pkg)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    local = (a.asname or a.name).split(".")[0]
                    if a.name.split(".")[0] == astwalk._PKG:
                        dotted = a.name[len(astwalk._PKG):].lstrip(".")
                        mi.imports[a.asname or a.name] = ("module", dotted)
                    else:
                        mi.imports[local] = ("ext", a.name.split(".")[0])
            elif isinstance(node, ast.ClassDef):
                self._collect_class(mi, ms, node)
        for node in ms.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                mi.functions[node.name] = node
        return mi

    def _collect_import_from(self, mi, node, pkg):
        if node.level:
            parts = pkg.split(".") if pkg else []
            parts = parts[:len(parts) - (node.level - 1)] if node.level > 1 \
                else parts
            base = ".".join(parts + (node.module.split(".")
                                     if node.module else []))
        elif node.module and node.module.split(".")[0] == astwalk._PKG:
            base = node.module[len(astwalk._PKG):].lstrip(".")
        else:
            for a in node.names:
                mi.imports[a.asname or a.name] = (
                    "ext", (node.module or "").split(".")[0])
            return
        for a in node.names:
            local = a.asname or a.name
            sub = f"{base}.{a.name}" if base else a.name
            if sub in self.mod_names:
                mi.imports[local] = ("module", sub)
            else:
                mi.imports[local] = ("symbol", base, a.name)

    def _collect_class(self, mi, ms, node):
        ci = ClassInfo(mod=ms.dotted, name=node.name, rel=ms.rel, node=node,
                       bases=node.bases)
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ci.methods[item.name] = item
        # lock fields + guarded_by annotations: any `self.X = ...` in any
        # method (locks are normally minted in __init__, but lazy fields
        # exist); annotation may sit on the assignment line or on a
        # dedicated comment line directly above it
        for meth in ci.methods.values():
            for sub in ast.walk(meth):
                targets = []
                if isinstance(sub, ast.Assign):
                    targets, value = sub.targets, sub.value
                elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
                    targets, value = [sub.target], sub.value
                else:
                    continue
                for t in targets:
                    if not (isinstance(t, ast.Attribute)
                            and _is_self(t.value)):
                        continue
                    kind = self._lock_kind(mi, value)
                    if kind is not None:
                        ci.locks[t.attr] = kind
                        ci.lock_lines[t.attr] = sub.lineno
                        continue
                    m = GUARDED_RE.search(ms.line(sub.lineno))
                    if m is None and _is_comment_line(ms.line(
                            sub.lineno - 1)):
                        m = GUARDED_RE.search(ms.line(sub.lineno - 1))
                    if m:
                        ci.guarded[t.attr] = m.group(1)
        mi.classes.setdefault(node.name, ci)

    def _lock_kind(self, mi, value):
        """The lock kind if this RHS mints a lock (walks through `x or
        threading.Lock()` BoolOps and similar wrappers)."""
        for sub in ast.walk(value):
            if not (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and isinstance(sub.func.value, ast.Name)):
                continue
            base = sub.func.value.id
            ref = mi.imports.get(base)
            if ref is not None:
                if ref[0] == "ext":
                    base = ref[1]
                elif ref[0] == "module":
                    base = ref[1].rsplit(".", 1)[-1] or ref[1]
            kind = _LOCK_CALLS.get((base, sub.func.attr))
            if kind:
                return kind
        return None

    def _resolve_instances(self):
        """Module-level `NAME = ClassName(...)` (and known factory calls
        like `metrics.counter(...)`) -> instance map; iterate to a
        fixpoint so cross-module references resolve regardless of file
        order."""
        for _ in range(4):
            changed = False
            for mi in self.modules.values():
                for stmt in mi.ms.tree.body:
                    if not (isinstance(stmt, ast.Assign)
                            and len(stmt.targets) == 1
                            and isinstance(stmt.targets[0], ast.Name)
                            and isinstance(stmt.value, ast.Call)):
                        continue
                    name = stmt.targets[0].id
                    if name in mi.instances:
                        continue
                    qual = self._instance_class(mi, stmt.value)
                    if qual is not None:
                        mi.instances[name] = qual
                        changed = True
            if not changed:
                return

    def _instance_class(self, mi, call):
        f = call.func
        if isinstance(f, ast.Name):
            r = self.resolve(mi.ms.dotted, f.id)
            if r and r[0] == "class":
                return r[1].qual
        elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            r = self.resolve(mi.ms.dotted, f.value.id)
            if r and r[0] == "module":
                r2 = self.resolve(r[1], f.attr)
                if r2 and r2[0] == "class":
                    return r2[1].qual
            elif r and r[0] == "instance":
                owner = self.class_by_qual_get(r[1])
                if owner is not None:
                    ret = _FACTORY_RETURNS.get((owner.name, f.attr))
                    if ret and ret in self.modules[owner.mod].classes:
                        return self.modules[owner.mod].classes[ret].qual
        return None

    def class_by_qual_get(self, qual):
        for mi in self.modules.values():
            for ci in mi.classes.values():
                if ci.qual == qual:
                    return ci
        return None

    # --- resolution -----------------------------------------------------------
    def resolve(self, mod: str, name: str, depth: int = 0):
        """-> ("class", ClassInfo) | ("func", mod, name) |
        ("instance", class qual) | ("module", dotted) | None"""
        if depth > 6 or mod not in self.modules:
            return None
        mi = self.modules[mod]
        if name in mi.classes:
            return ("class", mi.classes[name])
        if name in mi.functions:
            return ("func", mod, name)
        if name in mi.instances:
            return ("instance", mi.instances[name])
        ref = mi.imports.get(name)
        if ref is None:
            return None
        if ref[0] == "module":
            return ("module", ref[1])
        if ref[0] == "symbol":
            return self.resolve(ref[1], ref[2], depth + 1)
        return None

    # --- inheritance-aware views ---------------------------------------------
    def mro(self, ci: ClassInfo, _seen=None) -> list:
        _seen = _seen or set()
        if ci.qual in _seen:
            return []
        _seen.add(ci.qual)
        out = [ci]
        for b in ci.bases:
            base_ci = None
            if isinstance(b, ast.Name):
                r = self.resolve(ci.mod, b.id)
                if r and r[0] == "class":
                    base_ci = r[1]
            elif isinstance(b, ast.Attribute) and isinstance(b.value,
                                                            ast.Name):
                r = self.resolve(ci.mod, b.value.id)
                if r and r[0] == "module":
                    r2 = self.resolve(r[1], b.attr)
                    if r2 and r2[0] == "class":
                        base_ci = r2[1]
            if base_ci is not None:
                out += self.mro(base_ci, _seen)
        return out

    def all_locks(self, ci: ClassInfo) -> dict:
        """attr -> (kind, defining class qual), own shadowing bases."""
        out: dict = {}
        for c in reversed(self.mro(ci)):
            for attr, kind in c.locks.items():
                out[attr] = (kind, c.qual)
        return out

    def all_guarded(self, ci: ClassInfo) -> dict:
        out: dict = {}
        for c in reversed(self.mro(ci)):
            out.update(c.guarded)
        return out

    def find_method(self, ci: ClassInfo, name: str):
        for c in self.mro(ci):
            if name in c.methods:
                return c, c.methods[name]
        return None, None


def _parse_holds(line: str) -> set:
    m = HOLDS_RE.search(line)
    if not m:
        return set()
    return {s.strip() for s in m.group(1).split(",")}


def _is_comment_line(line: str) -> bool:
    return line.lstrip().startswith("#")


def _suppressed(ms, lineno: int) -> bool:
    """unguarded-ok on the line itself, or on a comment-ONLY line directly
    above (a trailing tag on the PREVIOUS statement must not leak down)."""
    if UNGUARDED_OK in ms.line(lineno):
        return True
    prev = ms.line(lineno - 1)
    return _is_comment_line(prev) and UNGUARDED_OK in prev


class _Analyzer:
    def __init__(self, idx: _Index):
        self.idx = idx
        self.findings: list = list(idx.findings)
        self.edges: dict = {}   # (a, b) -> where (first witness)
        self._memo: dict = {}

    # === pass 1+2: annotations ===============================================
    def check_annotations(self):
        for mi in self.idx.modules.values():
            for ci in mi.classes.values():
                locks = self.idx.all_locks(ci)
                for attr, lockname in sorted(ci.guarded.items()):
                    if lockname not in locks:
                        self.findings.append(Finding(
                            "error", "guarded-by-unknown-lock",
                            f"{ci.rel}:{ci.node.lineno}",
                            f"{ci.qual}.{attr} declares guarded_by: "
                            f"{lockname}, but {ci.name} owns no such lock "
                            f"field"))
                if not locks:
                    continue
                guarded = self.idx.all_guarded(ci)
                for name, meth in sorted(ci.methods.items()):
                    self._check_method(mi, ci, meth, locks, guarded)
                self._warn_unannotated(mi, ci, locks, guarded)

    def _check_method(self, mi, ci, meth, locks, guarded):
        ms = mi.ms
        if meth.name == "__init__":
            return
        held0 = _parse_holds(ms.line(meth.lineno))
        for h in held0:
            if h not in locks:
                self.findings.append(Finding(
                    "error", "holds-unknown-lock",
                    f"{ci.rel}:{meth.lineno}",
                    f"{ci.qual}.{meth.name} declares `lint: holds {h}` "
                    f"but {ci.name} owns no such lock field"))

        def visit(node, held):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested def: runs LATER — lexically enclosing locks are
                # NOT held at call time (the safe direction)
                inner = _parse_holds(ms.line(node.lineno))
                for child in node.body:
                    visit(child, inner)
                return
            if isinstance(node, ast.Lambda):
                visit(node.body, set())
                return
            if isinstance(node, ast.ClassDef):
                return  # nested classes are analyzed as their own scope
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acq = set()
                for item in node.items:
                    ce = item.context_expr
                    if (isinstance(ce, ast.Attribute) and _is_self(ce.value)
                            and ce.attr in locks):
                        acq.add(ce.attr)
                    visit(ce, held)
                for child in node.body:
                    visit(child, held | acq)
                return
            if (isinstance(node, ast.Attribute) and _is_self(node.value)
                    and node.attr in guarded):
                lockname = guarded[node.attr]
                if lockname not in held and not _suppressed(ms, node.lineno):
                    self.findings.append(Finding(
                        "error", "guarded-by",
                        f"{ci.rel}:{node.lineno}",
                        f"{ci.qual}.{meth.name} touches self.{node.attr} "
                        f"(guarded_by: {lockname}) outside `with "
                        f"self.{lockname}`; wrap it, annotate the def "
                        f"`# lint: holds {lockname}`, or tag the line "
                        f"`# lint: unguarded-ok`"))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for child in meth.body:
            visit(child, held0)

    def _warn_unannotated(self, mi, ci, locks, guarded):
        ms = mi.ms
        mutable_calls = {"dict", "list", "set", "OrderedDict", "defaultdict",
                         "deque"}
        # attr -> list of (lineno, flagged, reviewed): flagged = a store
        # that makes the attr look like mutable shared state (assigned
        # outside __init__, or seeded with a mutable container); reviewed
        # = any site carries the unguarded-ok tag
        sites: dict = {}
        for name, meth in ci.methods.items():
            in_init = name == "__init__"
            for sub in ast.walk(meth):
                if isinstance(sub, ast.Assign):
                    targets, value = sub.targets, sub.value
                elif isinstance(sub, (ast.AnnAssign, ast.AugAssign)) \
                        and getattr(sub, "value", None) is not None:
                    targets, value = [sub.target], sub.value
                else:
                    continue
                for t in targets:
                    if not (isinstance(t, ast.Attribute)
                            and _is_self(t.value)):
                        continue
                    attr = t.attr
                    if attr in locks or attr in guarded:
                        continue
                    mutable = isinstance(value, (
                        ast.Dict, ast.List, ast.Set, ast.DictComp,
                        ast.ListComp, ast.SetComp)) or (
                        isinstance(value, ast.Call)
                        and isinstance(value.func, ast.Name)
                        and value.func.id in mutable_calls)
                    sites.setdefault(attr, []).append(
                        (sub.lineno, (not in_init) or mutable,
                         _suppressed(ms, sub.lineno)))
        for attr, recs in sorted(sites.items()):
            if any(reviewed for _, _, reviewed in recs):
                continue
            flagged = [ln for ln, fl, _ in recs if fl]
            if flagged:
                self.findings.append(Finding(
                    "warn", "unannotated-mutable-attr",
                    f"{ci.rel}:{min(flagged)}",
                    f"{ci.qual}.{attr} is mutable shared state on a "
                    f"lock-owning class with no `# guarded_by:` "
                    f"annotation (tag `# lint: unguarded-ok` if reviewed)"))

    # === pass 3: lock-acquisition graph ======================================
    def build_lock_graph(self):
        for mi in self.idx.modules.values():
            for ci in mi.classes.values():
                for name in ci.methods:
                    self._may_acquire(("meth", ci.qual, name))
            for name in mi.functions:
                self._may_acquire(("func", mi.ms.dotted, name))

    def _local_instances(self, mi, fn) -> dict:
        """Local name -> class qual for `name = <constructor-or-factory>()`
        bindings inside one function: `c = reg.counter(...)` (the known-
        factory table), `q = QueryCache()`, and chains through earlier
        locals — iterated to a small fixpoint so `reg = MetricRegistry();
        c = reg.counter(...)` resolves both hops. Re-bindings keep the
        FIRST resolution (an under-approximation, the safe direction)."""
        out: dict = {}
        for _ in range(3):
            changed = False
            for sub in ast.walk(fn):
                if not (isinstance(sub, ast.Assign)
                        and len(sub.targets) == 1
                        and isinstance(sub.targets[0], ast.Name)
                        and isinstance(sub.value, ast.Call)):
                    continue
                name = sub.targets[0].id
                if name in out:
                    continue
                qual = self._call_instance_class(mi, sub.value, out)
                if qual is not None:
                    out[name] = qual
                    changed = True
            if not changed:
                break
        return out

    def _call_instance_class(self, mi, call, local_insts: dict):
        """Class qual a call expression constructs, resolving the callee
        through module names, module-level instances, AND function locals
        (`local_insts`) for the known factory methods."""
        f = call.func
        if isinstance(f, ast.Name):
            r = self.idx.resolve(mi.ms.dotted, f.id)
            if r and r[0] == "class":
                return r[1].qual
            return None
        if not (isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)):
            return None
        base = f.value.id
        owner_qual = local_insts.get(base)
        if owner_qual is None:
            r = self.idx.resolve(mi.ms.dotted, base)
            if r and r[0] == "instance":
                owner_qual = r[1]
            elif r and r[0] == "module":
                r2 = self.idx.resolve(r[1], f.attr)
                if r2 and r2[0] == "class":
                    return r2[1].qual
        if owner_qual is None:
            return None
        owner = self.idx.class_by_qual.get(owner_qual)
        if owner is None:
            return None
        ret = _FACTORY_RETURNS.get((owner.name, f.attr))
        if ret and ret in self.idx.modules[owner.mod].classes:
            return self.idx.modules[owner.mod].classes[ret].qual
        return None

    def _lock_node_of_expr(self, mi, ci, expr, local_insts=None):
        """lock node id ("qual._attr", kind) for a with-context expr, or
        None: self._lock / INSTANCE._lock / mod.INSTANCE._lock /
        factory-bound LOCAL._lock."""
        if not isinstance(expr, ast.Attribute):
            return None
        owner = None
        if _is_self(expr.value) and ci is not None:
            owner = ci
        elif isinstance(expr.value, ast.Name):
            if local_insts and expr.value.id in local_insts:
                owner = self.idx.class_by_qual.get(
                    local_insts[expr.value.id])
            else:
                r = self.idx.resolve(mi.ms.dotted, expr.value.id)
                if r and r[0] == "instance":
                    owner = self.idx.class_by_qual.get(r[1])
        elif (isinstance(expr.value, ast.Attribute)
              and isinstance(expr.value.value, ast.Name)):
            r = self.idx.resolve(mi.ms.dotted, expr.value.value.id)
            if r and r[0] == "module":
                r2 = self.idx.resolve(r[1], expr.value.attr)
                if r2 and r2[0] == "instance":
                    owner = self.idx.class_by_qual.get(r2[1])
        if owner is None:
            return None
        locks = self.idx.all_locks(owner)
        if expr.attr not in locks:
            return None
        kind, defining = locks[expr.attr]
        return (f"{defining}.{expr.attr}", kind)

    def _resolve_call(self, mi, ci, call, local_insts=None):
        """-> list of callable keys this call may enter."""
        f = call.func
        out = []
        if isinstance(f, ast.Name):
            r = self.idx.resolve(mi.ms.dotted, f.id)
            if r and r[0] == "func":
                out.append(("func", r[1], r[2]))
            elif r and r[0] == "class":
                dc, m = self.idx.find_method(r[1], "__init__")
                if m is not None:
                    out.append(("meth", dc.qual, "__init__"))
        elif isinstance(f, ast.Attribute):
            v = f.value
            target_ci = None
            if _is_self(v) and ci is not None:
                target_ci = ci
            elif isinstance(v, ast.Name):
                if local_insts and v.id in local_insts:
                    target_ci = self.idx.class_by_qual.get(local_insts[v.id])
                else:
                    r = self.idx.resolve(mi.ms.dotted, v.id)
                    if r and r[0] == "instance":
                        target_ci = self.idx.class_by_qual.get(r[1])
                    elif r and r[0] == "module":
                        r2 = self.idx.resolve(r[1], f.attr)
                        if r2 and r2[0] == "func":
                            out.append(("func", r2[1], r2[2]))
            elif isinstance(v, ast.Attribute) and isinstance(v.value,
                                                             ast.Name):
                r = self.idx.resolve(mi.ms.dotted, v.value.id)
                if r and r[0] == "module":
                    r2 = self.idx.resolve(r[1], v.attr)
                    if r2 and r2[0] == "instance":
                        target_ci = self.idx.class_by_qual.get(r2[1])
            if target_ci is not None:
                dc, m = self.idx.find_method(target_ci, f.attr)
                if m is not None:
                    out.append(("meth", dc.qual, f.attr))
        return out

    def _callable_ast(self, key):
        if key[0] == "meth":
            ci = self.idx.class_by_qual.get(key[1])
            if ci is None or key[2] not in ci.methods:
                return None, None, None
            return self.idx.modules[ci.mod], ci, ci.methods[key[2]]
        mi = self.idx.modules.get(key[1])
        if mi is None or key[2] not in mi.functions:
            return None, None, None
        return mi, None, mi.functions[key[2]]

    def _may_acquire(self, key, _stack=frozenset()):
        if key in self._memo:
            return self._memo[key]
        if key in _stack:
            return set()  # recursion: the fixpoint under-approximates
        mi, ci, fn = self._callable_ast(key)
        if fn is None:
            return set()
        stack = _stack | {key}
        acquired: set = set()
        ms = mi.ms
        # locals bound from constructors / known factories (c =
        # reg.counter(...)) participate in call + lock-expr resolution
        local_insts = self._local_instances(mi, fn)
        locks = self.idx.all_locks(ci) if ci is not None else {}
        held0 = set()
        for h in _parse_holds(ms.line(fn.lineno)):
            if h in locks:
                kind, defining = locks[h]
                held0.add((f"{defining}.{h}", kind))

        def add_edge(a, b, lineno, direct):
            if a[0] == b[0]:
                if a[1] == "lock":
                    # direct lexical nesting of a non-reentrant lock is a
                    # certain deadlock; a re-acquire reached through calls
                    # might target a DIFFERENT instance of the same lock
                    # class, so it only warns
                    self.findings.append(Finding(
                        "error" if direct else "warn",
                        "self-deadlock" if direct else "recursive-acquire",
                        f"{ms.rel}:{lineno}",
                        f"non-reentrant lock {a[0]} acquired while "
                        f"already held on this path"
                        + ("" if direct else
                           " (through calls — deadlock iff it is the "
                           "same instance)")))
                return
            self.edges.setdefault(
                (a[0], b[0]), f"{ms.rel}:{lineno} (in {key[1]}.{key[2]})")

        def visit(node, held):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                return  # deferred execution / separate scope
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acq = []
                for item in node.items:
                    ln = self._lock_node_of_expr(mi, ci, item.context_expr,
                                                 local_insts)
                    if ln is not None:
                        for h in held:
                            add_edge(h, ln, node.lineno, direct=True)
                        acq.append(ln)
                        acquired.add(ln)
                    visit(item.context_expr, held)
                for child in node.body:
                    visit(child, held | set(acq))
                return
            if isinstance(node, ast.Call):
                for ck in self._resolve_call(mi, ci, node, local_insts):
                    sub = self._may_acquire(ck, stack)
                    for ln in sub:
                        acquired.add(ln)
                        for h in held:
                            add_edge(h, ln, node.lineno, direct=False)
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for child in fn.body:
            visit(child, held0)
        self._memo[key] = acquired
        return acquired

    def cycle_findings(self):
        adj: dict = {}
        for a, b in self.edges:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
        for scc in _tarjan_sccs(adj):
            chains = [f"{a} -> {b} at {w}"
                      for (a, b), w in sorted(self.edges.items())
                      if a in scc and b in scc]
            self.findings.append(Finding(
                "error", "lock-order-cycle", chains[0].split(" at ")[-1]
                if chains else "?",
                f"potential deadlock: lock-order cycle over "
                f"{sorted(scc)}; " + "; ".join(chains)))


def _tarjan_sccs(adj: dict) -> list:
    """SCCs with more than one node (iterative Tarjan)."""
    index: dict = {}
    low: dict = {}
    onstack: set = set()
    stack: list = []
    out: list = []
    counter = [0]
    for root in sorted(adj):
        if root in index:
            continue
        work = [(root, iter(sorted(adj[root])))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        onstack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    onstack.add(w)
                    work.append((w, iter(sorted(adj[w]))))
                    advanced = True
                    break
                if w in onstack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    onstack.discard(w)
                    scc.append(w)
                    if w == v:
                        break
                if len(scc) > 1:
                    out.append(set(scc))
    return out


def check_sources(sources) -> Report:
    idx = _Index(sources)
    an = _Analyzer(idx)
    an.check_annotations()
    an.build_lock_graph()
    an.cycle_findings()
    n_locks = sum(len(ci.locks) for mi in idx.modules.values()
                  for ci in mi.classes.values())
    n_guarded = sum(len(ci.guarded) for mi in idx.modules.values()
                    for ci in mi.classes.values())
    order = {"error": 0, "warn": 1}
    an.findings.sort(key=lambda f: (order[f.severity], f.where, f.rule))
    return Report(findings=an.findings, stats={
        "locks": n_locks, "guarded_attrs": n_guarded,
        "edges": len(an.edges),
        "classes": sum(len(mi.classes) for mi in idx.modules.values()),
    })


def check_package(repo: str | None = None) -> Report:
    return check_sources(astwalk.package_sources(repo))


def check_fixture(src: str,
                  rel: str = "starrocks_tpu_torch/fixture.py") -> Report:
    """Golden bad-fixture entry: analyze one in-memory module."""
    return check_sources([astwalk.parse_fixture(src, rel)])
