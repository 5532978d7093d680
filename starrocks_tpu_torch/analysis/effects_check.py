"""Interprocedural effect analyzer: leak-freedom, kill-latency bounds,
and no-blocking-under-lock, proven from source over starrocks_tpu_torch/.

Reference behavior: the reference enforces structural invariants with
machine-checked CI gates (clang-tidy bundles + the module-boundary
manifest); the dynamic half of THIS repo's invariant — "a killed worker
must never wedge a query, leak an admission slot, or corrupt the
catalog" — lives in tools/chaos_fuzz.py, which only probes the paths its
workload happens to drive. This pass closes the gap statically: it
computes a per-function **effect summary** and enforces four contracts
over every acquire/blocking/checkpoint site in the package, whether or
not any test ever executes it.

Effect summaries (computed per method/function, resolved through calls
exactly as concur_check's lock graph resolves them — self methods,
module functions, module-level instances, factory-bound locals):

- **acquires** — resources that must be released on every exit path:
  raw lock ``.acquire()`` calls, ``open()``/``os.open()`` handles,
  failpoint ``arm()``s, admission ``admit()`` slots;
- **blocking** — operations that can stall a thread: compile
  (``.lower()``/``.compile()``), host waits on the device
  (``torch.cuda.synchronize``, an Event's ``.synchronize``, and the
  copies of a tensor to the host: ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``.to("cpu")``), file IO (``open``/``os.fsync``), socket
  traffic (http.client/socket locals), ``time.sleep``, ``.wait()`` and
  thread ``.join(timeout=)`` queue-waits;
- **checkpoints** — cooperative-cancellation polls
  (``lifecycle.checkpoint(...)`` / ``ctx.check(...)``), propagated
  through calls so a loop that calls into the engine inherits the
  engine's checkpoint plumbing.

The four contracts (all strict-fatal):

1. **exception-safe acquire** (`unprotected-acquire`) — every acquire
   must be a ``with`` item, sit inside a ``try`` that has a ``finally``,
   or be an assignment followed immediately (no statement that can
   raise) by such a ``try`` — the chaos-fuzz leak class, proven
   statically. Failpoint arms are paired instead: the arming function
   must also reach a ``disarm``.
2. **checkpoint density** (`checkpoint-free-blocking-loop`) — a loop
   whose body (transitively) blocks must (transitively) reach a
   cancellation checkpoint every iteration, bounding kill/deadline
   latency to one stage by construction. Loops inside daemon-thread
   targets (``threading.Thread(target=self._run)`` bodies) are exempt —
   they are not query context. ``# lint: checkpoint-exempt <reason>``
   (loop line or the line above) documents a reviewed exception.
3. **no blocking under lock** (`blocking-under-lock`) — no compile /
   device / socket / disk / sleep effect, direct or through calls, while
   a lockdep-tracked lock is lexically held (the DeviceCache "expensive
   work outside the lock" rule, generalized). Condition ``.wait()`` on
   the held lock is NOT a violation (it releases while waiting).
   ``# lint: blocking-ok <reason>`` on the site line or the owning
   ``def`` line documents a reviewed exception (e.g. the journal
   checkpoint's fsync-under-lock durability contract) and removes the
   effect from the function's propagated summary.
4. **daemon-thread lifecycle** (`non-daemon-thread` /
   `thread-without-stop`) — every started ``threading.Thread`` must be
   ``daemon=True`` (literal) and its owning class must expose a
   reachable stop (``stop``/``close``/``shutdown``) — the
   MetricsHistory/watchdog pattern.

Every suppression annotation must carry a reason: a bare tag is a
warn-level `suppression-missing-reason` finding, and
``concur_lint --strict-warn`` ratchets unexplained suppressions to zero.

Scope and honesty: resolution is name-based and intra-package (calls
through function values, dynamic dispatch, and containers are not
followed), so summaries under-approximate — the checker can miss an
effect, never invent one. Compiled-program dispatch through stored
function objects is invisible; the direct markers (the host waits
above, ``.lower()``) are the anchors.

Loadable standalone (a gate may path-load it); imports
nothing from the package but astwalk + concur_check (whose resolution
index it shares — one parse, one name index, three analyzers).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

try:  # normal package import
    from . import astwalk, concur_check
except ImportError:  # loaded standalone by file path (tools/ gates)
    import importlib.util as _ilu
    import sys as _sys

    _here = os.path.dirname(os.path.abspath(__file__))

    def _path_load(name, fn):
        mod = _sys.modules.get(name)
        if mod is None:
            spec = _ilu.spec_from_file_location(name, os.path.join(_here, fn))
            mod = _ilu.module_from_spec(spec)
            _sys.modules[name] = mod
            spec.loader.exec_module(mod)
        return mod

    astwalk = _path_load("sr_astwalk", "astwalk.py")
    concur_check = _path_load("sr_concur_check", "concur_check.py")

Finding = concur_check.Finding

# the (?<!`) keeps backtick-quoted doc mentions of the tags (like the
# ones in this module's own docstring) out of the suppression census
BLOCKING_OK_RE = re.compile(r"(?<!`)#\s*lint:\s*blocking-ok\b[\s:—–-]*(.*)")
CKPT_EXEMPT_RE = re.compile(
    r"(?<!`)#\s*lint:\s*checkpoint-exempt\b[\s:—–-]*(.*)")

# lock-wrapper protocol: raw .acquire()/.release() inside these functions
# IS the lock implementation (lockdep's DebugLock/DebugRLock), not a use
_WRAPPER_FUNCS = {"acquire", "release", "locked", "__enter__", "__exit__",
                  "_acquire_restore", "_release_save", "_is_owned"}

# blocking kinds that count for each contract: condition/event waits are
# excluded from C3 (a Condition.wait on the held lock RELEASES it), and
# they are exactly what C2's checkpointed wait-loops are made of
_LOOP_KINDS = frozenset(("sleep", "wait", "socket", "io", "device",
                         "compile"))
_UNDER_LOCK_KINDS = frozenset(("sleep", "socket", "io", "device",
                               "compile"))

_SOCKET_ROOTS = frozenset(("socket", "http"))
_SOCKET_CTORS = frozenset(("HTTPConnection", "HTTPSConnection",
                           "create_connection", "socket"))
_SOCKET_METHODS = frozenset(("request", "getresponse", "connect",
                             "create_connection", "sendall", "send",
                             "recv", "accept", "makefile"))
_STOP_METHODS = frozenset(("stop", "close", "shutdown"))
_PROC_STOP_METHODS = _STOP_METHODS | frozenset(("terminate", "kill"))


def _numpy_made(node) -> bool:
    """Whether an expression is, by its text, a numpy value: a call of a
    `np.`/`numpy.` function, or a method of one (`np.asarray(x).tolist()`,
    `np.unique(a)[0].item()`)."""
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            fn = node.func
            if (isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name)
                    and fn.value.id in ("np", "numpy")):
                return True
            if not isinstance(fn, ast.Attribute):
                return False
            node = fn.value
        else:
            return False


def _device_wait(call):
    """Label of a host wait on the device, or None: `torch.cuda.
    synchronize()`, an Event's `.synchronize()`, and the copies that bring
    a tensor to the host (`.item()`, `.tolist()`, `.cpu()`, `.numpy()`,
    `.to("cpu")`). Resolution is by name: `.item()`/`.tolist()` count
    unless the receiver is, by its text, made by numpy — the direction
    that misses no wait of a tensor."""
    f = call.func
    attr = f.attr
    if attr == "synchronize":
        return ".synchronize()"
    if attr in ("cpu", "numpy") and not call.args:
        return f".{attr}()"  # no numpy value has these methods
    if attr in ("item", "tolist") and not call.args and not _numpy_made(
            f.value):
        return f".{attr}()"
    if attr == "to":
        dev = [a for a in call.args[:1]] + [
            kw.value for kw in call.keywords if kw.arg == "device"]
        if any(isinstance(a, ast.Constant) and a.value == "cpu"
               for a in dev):
            return '.to("cpu")'
    return None


@dataclasses.dataclass
class Effects:
    """One callable's interprocedural effect summary."""

    blocking: dict = dataclasses.field(default_factory=dict)
    # kind -> first witness "rel:line via <what>" (suppressed sites and
    # deferred (nested-def) code excluded)
    checkpoints: bool = False   # reaches a cancellation checkpoint


@dataclasses.dataclass(frozen=True)
class AcquireSite:
    kind: str     # lock | file | failpoint | slot
    rel: str
    line: int
    func: str     # qualified owner, e.g. "runtime.workgroup.WorkgroupManager.admit"
    module: str   # dotted module


def _tag_reason(regex, line: str):
    """(tagged, reason) for a suppression regex over one source line."""
    m = regex.search(line)
    if m is None:
        return False, ""
    return True, m.group(1).strip().rstrip("—-: ").strip()


class _EffectAnalyzer:
    def __init__(self, idx):
        self.idx = idx
        # borrow concur_check's resolver: one resolution semantics for
        # the lock graph and the effect graph
        self.res = concur_check._Analyzer(idx)
        self.findings: list = []
        self._memo: dict = {}
        self.acquire_sites: list = []
        self.stats = {"functions": 0, "acquire_sites": 0,
                      "blocking_sites": 0, "checkpoint_sites": 0,
                      "threads": 0, "procs": 0, "suppressions": 0,
                      "suppressions_unexplained": 0}
        self.thread_targets: set = set()
        self._collect_thread_targets()
        self._count_suppressions()

    # --- suppression helpers --------------------------------------------------
    def _suppressed_blocking(self, ms, lineno: int, def_lineno: int) -> bool:
        return (BLOCKING_OK_RE.search(ms.line(lineno)) is not None
                or BLOCKING_OK_RE.search(ms.line(def_lineno)) is not None)

    def _loop_exempt(self, ms, lineno: int) -> bool:
        for ln in (lineno, lineno - 1):
            line = ms.line(ln)
            if CKPT_EXEMPT_RE.search(line) is not None and (
                    ln == lineno or line.lstrip().startswith("#")):
                return True
        return False

    def _count_suppressions(self):
        for mi in self.idx.modules.values():
            for lineno, line in enumerate(mi.ms.lines, 1):
                for regex in (BLOCKING_OK_RE, CKPT_EXEMPT_RE):
                    tagged, reason = _tag_reason(regex, line)
                    if not tagged:
                        continue
                    self.stats["suppressions"] += 1
                    if not reason:
                        self.stats["suppressions_unexplained"] += 1
                        self.findings.append(Finding(
                            "warn", "suppression-missing-reason",
                            f"{mi.ms.rel}:{lineno}",
                            "suppression annotation without a reason — "
                            "every reviewed exception must say why "
                            "(`# lint: blocking-ok <reason>` / "
                            "`# lint: checkpoint-exempt <reason>`)"))

    # --- thread-target discovery ----------------------------------------------
    def _is_thread_ctor(self, mi, call) -> bool:
        f = call.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            ref = mi.imports.get(f.value.id)
            return (f.attr == "Thread" and ref is not None
                    and ref[0] == "ext" and ref[1] == "threading")
        if isinstance(f, ast.Name):
            ref = mi.imports.get(f.id)
            return (f.id == "Thread" or (
                ref is not None and ref[0] == "ext"
                and ref[1] == "threading")) and f.id == "Thread"
        return False

    def _collect_thread_targets(self):
        """Resolve every `threading.Thread(target=...)` to its callable
        key: loops inside those bodies are daemon-service loops, not
        query context (contract 2 exempts them)."""
        for mi in self.idx.modules.values():
            for ci, fn in self._callables(mi):
                for node in self._walk_body(fn):
                    if not (isinstance(node, ast.Call)
                            and self._is_thread_ctor(mi, node)):
                        continue
                    for kw in node.keywords:
                        if kw.arg != "target":
                            continue
                        t = kw.value
                        if (isinstance(t, ast.Attribute)
                                and concur_check._is_self(t.value)
                                and ci is not None):
                            dc, m = self.idx.find_method(ci, t.attr)
                            if m is not None:
                                self.thread_targets.add(
                                    ("meth", dc.qual, t.attr))
                        elif isinstance(t, ast.Name):
                            r = self.idx.resolve(mi.ms.dotted, t.id)
                            if r and r[0] == "func":
                                self.thread_targets.add(
                                    ("func", r[1], r[2]))

    # --- walking helpers ------------------------------------------------------
    def _callables(self, mi):
        """(ClassInfo | None, fn) for every method + module function."""
        for ci in mi.classes.values():
            for fn in ci.methods.values():
                yield ci, fn
        for fn in mi.functions.values():
            yield None, fn

    def _walk_body(self, fn):
        """ast.walk over a function body, skipping nested defs/lambdas
        (deferred execution — their effects are not this callable's)."""
        stack = list(fn.body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def _ext(self, mi, node):
        """Top-level external module name a Name resolves to, or None."""
        if not isinstance(node, ast.Name):
            return None
        ref = mi.imports.get(node.id)
        if ref is not None and ref[0] == "ext":
            return ref[1]
        return None

    def _socket_locals(self, mi, fn) -> set:
        """Local names bound from http.client/socket constructors —
        method calls on them are socket effects."""
        out = set()
        for node in self._walk_body(fn):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)):
                continue
            root = node.value.func
            while isinstance(root, ast.Attribute):
                root = root.value
            if self._ext(mi, root) in _SOCKET_ROOTS:
                out.add(node.targets[0].id)
        return out

    # --- direct effect recognition --------------------------------------------
    def _direct_blocking(self, mi, call, socket_locals):
        """(kind, label) of a directly-blocking call, or None."""
        f = call.func
        if isinstance(f, ast.Name):
            if f.id == "open":
                return ("io", "open()")
            return None
        if not isinstance(f, ast.Attribute):
            return None
        attr, base = f.attr, f.value
        ext = self._ext(mi, base)
        if attr == "sleep" and ext == "time":
            return ("sleep", "time.sleep()")
        if attr == "wait":
            return ("wait", ".wait()")
        if attr == "join" and any(kw.arg == "timeout"
                                  for kw in call.keywords):
            return ("wait", "thread .join()")
        if ext == "os" and attr in ("open", "fsync"):
            return ("io", f"os.{attr}()")
        wait = _device_wait(call)
        if wait is not None:
            return ("device", wait)
        if attr == "lower" and (call.args or call.keywords):
            return ("compile", ".lower()")  # str.lower takes no args
        if attr == "compile" and ext != "re":
            return ("compile", ".compile()")
        if attr in _SOCKET_METHODS and (
                ext in _SOCKET_ROOTS
                or (isinstance(base, ast.Name)
                    and base.id in socket_locals)):
            return ("socket", f".{attr}()")
        return None

    def _is_checkpoint(self, call) -> bool:
        f = call.func
        if isinstance(f, ast.Name):
            return f.id == "checkpoint"
        if isinstance(f, ast.Attribute):
            if f.attr == "checkpoint":
                return True
            return (f.attr == "check" and isinstance(f.value, ast.Name)
                    and f.value.id == "ctx")
        return False

    def _direct_acquire(self, mi, call, fn_name):
        """(kind, label) of a direct acquire call, or None."""
        f = call.func
        if isinstance(f, ast.Name):
            if f.id == "open":
                return ("file", "open()")
            r = self.idx.resolve(mi.ms.dotted, f.id)
            if r and r[0] == "func" and r[2] == "arm" \
                    and r[1].endswith("failpoint"):
                return ("failpoint", "arm()")
            return None
        if not isinstance(f, ast.Attribute):
            return None
        attr, base = f.attr, f.value
        ext = self._ext(mi, base)
        if attr == "acquire" and fn_name not in _WRAPPER_FUNCS:
            return ("lock", ".acquire()")
        if attr == "open" and ext == "os":
            return ("file", "os.open()")
        if attr == "arm" and fn_name != "arm":
            if isinstance(base, ast.Name):
                r = self.idx.resolve(mi.ms.dotted, base.id)
                if (r and ((r[0] == "module"
                            and r[1].endswith("failpoint"))
                           or (r[0] == "instance"
                               and "failpoint" in r[1]))):
                    return ("failpoint", ".arm()")
                # `from ...runtime import failpoint` records a symbol
                # import that resolve() can't chase when the target
                # module is outside the analyzed source set (fixtures)
                ref = mi.imports.get(base.id)
                if ref is not None and "failpoint" in str(ref):
                    return ("failpoint", ".arm()")
            return None
        if attr in ("admit", "try_shared") and fn_name != attr:
            return ("slot", f".{attr}()")
        if attr == "charge" and fn_name != attr:
            # recorded in the summary; contract 1 does NOT enforce local
            # release — accountant charges are query-scoped by design:
            # query_scope's finally calls release_query on every exit
            # path (src_lint R5 pins that shape), so the scope owns the
            # release, not the charging site
            return ("mem", ".charge()")
        root = base
        while isinstance(root, ast.Attribute):
            root = root.value
        if attr in _SOCKET_CTORS and self._ext(mi, root) in _SOCKET_ROOTS:
            return ("socket", f"{attr}()")
        if attr == "Popen" and self._ext(mi, root) == "subprocess":
            # a spawned worker process is an acquire: someone must own
            # its termination (contract 4 enforces the stop pairing)
            return ("proc", "subprocess.Popen()")
        return None

    # --- effect summaries (memoized, interprocedural) -------------------------
    def effects(self, key, _stack=frozenset()) -> Effects:
        if key in self._memo:
            return self._memo[key]
        if key in _stack:
            return Effects()  # recursion: fixpoint under-approximates
        mi, ci, fn = self.res._callable_ast(key)
        if fn is None:
            return Effects()
        stack = _stack | {key}
        eff = Effects()
        ms = mi.ms
        local_insts = self.res._local_instances(mi, fn)
        socket_locals = self._socket_locals(mi, fn)
        for node in self._walk_body(fn):
            if not isinstance(node, ast.Call):
                continue
            if self._is_checkpoint(node):
                eff.checkpoints = True
                continue
            hit = self._direct_blocking(mi, node, socket_locals)
            if hit is not None:
                kind, label = hit
                if not self._suppressed_blocking(ms, node.lineno,
                                                 fn.lineno):
                    eff.blocking.setdefault(
                        kind, f"{ms.rel}:{node.lineno} via {label}")
                continue
            suppressed = self._suppressed_blocking(ms, node.lineno,
                                                   fn.lineno)
            for ck in self.res._resolve_call(mi, ci, node, local_insts):
                sub = self.effects(ck, stack)
                if sub.checkpoints:
                    eff.checkpoints = True
                if suppressed:
                    continue  # reviewed call: blocking does not propagate
                for kind, where in sub.blocking.items():
                    eff.blocking.setdefault(
                        kind,
                        f"{ms.rel}:{node.lineno} via "
                        f"{ck[1]}.{ck[2]} ({where})")
        self._memo[key] = eff
        return eff

    # === contract 1: exception-safe acquire ==================================
    @staticmethod
    def _may_raise(stmt) -> bool:
        """Conservative: a statement that contains any call, subscript,
        await, or raise can raise; plain name/attribute stores of
        names/constants cannot."""
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Call, ast.Subscript, ast.Raise,
                                 ast.Await, ast.BinOp, ast.Import,
                                 ast.ImportFrom)):
                return True
        return False

    def _check_acquires(self, mi, ci, fn, key):
        ms = mi.ms
        qual = f"{key[1]}.{key[2]}" if key[0] == "meth" \
            else (f"{key[1]}.{key[2]}" if key[1] else key[2])
        has_disarm = any(
            isinstance(n, ast.Call) and (
                (isinstance(n.func, ast.Name) and n.func.id == "disarm")
                or (isinstance(n.func, ast.Attribute)
                    and n.func.attr == "disarm"))
            for n in self._walk_body(fn))

        def record(kind, node):
            self.stats["acquire_sites"] += 1
            self.acquire_sites.append(AcquireSite(
                kind=kind, rel=ms.rel, line=node.lineno, func=qual,
                module=mi.ms.dotted))

        def calls_in(node, out):
            """Acquire calls inside one statement/expression, skipping
            nested defs and WITH-ITEM context expressions (a with-item
            acquire is protected by the with itself)."""
            stack = [node]
            while stack:
                n = stack.pop()
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                    continue
                if isinstance(n, ast.Call):
                    a = self._direct_acquire(mi, n, fn.name)
                    if a is not None:
                        out.append((a[0], a[1], n))
                stack.extend(ast.iter_child_nodes(n))

        def scan_block(stmts, protected):
            for i, st in enumerate(stmts):
                if isinstance(st, (ast.With, ast.AsyncWith)):
                    for item in st.items:
                        found: list = []
                        calls_in(item.context_expr, found)
                        for kind, _label, node in found:
                            record(kind, node)  # with-item: protected
                    scan_block(st.body, protected)
                    continue
                if isinstance(st, ast.Try):
                    shields = protected or bool(st.finalbody)
                    scan_block(st.body, shields)
                    for h in st.handlers:
                        scan_block(h.body, shields)
                    scan_block(st.orelse, shields)
                    scan_block(st.finalbody, protected)
                    continue
                if isinstance(st, (ast.If, ast.While, ast.For)):
                    found = []
                    calls_in(st.test if hasattr(st, "test") else st.iter,
                             found)
                    self._flag_unprotected(found, protected, has_disarm,
                                           record, ms, qual, stmts, i)
                    scan_block(st.body, protected)
                    scan_block(st.orelse, protected)
                    continue
                found = []
                calls_in(st, found)
                self._flag_unprotected(found, protected, has_disarm,
                                       record, ms, qual, stmts, i)

        scan_block(fn.body, False)

    def _guard_then_try(self, stmts, i) -> bool:
        """True when stmts[i] binds/tests an acquire and every following
        sibling statement up to a try-with-finally cannot raise — the
        `release = admit(); try: ... finally: release()` idiom and its
        gate form `if not gate.try_shared(): return MISS` + try-finally
        (the early return declines the acquire; nothing is held)."""
        st = stmts[i]
        if isinstance(st, ast.If):
            if st.orelse or not all(
                    isinstance(b, ast.Return) and not self._may_raise(b)
                    for b in st.body):
                return False
        elif not isinstance(st, (ast.Assign, ast.AnnAssign)):
            return False
        for nxt in stmts[i + 1:]:
            if isinstance(nxt, ast.Try) and nxt.finalbody:
                return True
            if self._may_raise(nxt) or not isinstance(
                    nxt, (ast.Assign, ast.AnnAssign, ast.Expr, ast.Pass)):
                return False
        return False

    def _flag_unprotected(self, found, protected, has_disarm, record,
                          ms, qual, stmts, i):
        for kind, label, node in found:
            record(kind, node)
            if protected or kind in ("mem", "proc"):
                continue  # mem: the query scope owns the release;
                #   proc: the spawning OWNER owns termination — contract 4
                #   requires its class to expose stop/terminate, which
                #   covers raise-paths local try-finally cannot (a worker
                #   may outlive the spawning call by design)
            if kind == "failpoint":
                if has_disarm:
                    continue
                self.findings.append(Finding(
                    "error", "unprotected-acquire",
                    f"{ms.rel}:{node.lineno}",
                    f"{qual} arms a failpoint via {label} but never "
                    f"reaches a disarm — pair it (failpoint.scoped) or "
                    f"disarm in a finally"))
                continue
            if self._guard_then_try(stmts, i):
                continue
            self.findings.append(Finding(
                "error", "unprotected-acquire",
                f"{ms.rel}:{node.lineno}",
                f"{qual} acquires a {kind} via {label} outside any "
                f"`with`/`try-finally` protection — a raise before the "
                f"release leaks it (the chaos-fuzz leak class); wrap "
                f"it or register the release on the QueryContext "
                f"cleanup stack inside a protected region"))

    # === contract 2: checkpoint density ======================================
    def _loop_effects(self, mi, ci, fn, loop, local_insts, socket_locals):
        """(blocking dict, checkpoints) over ONE loop body (transitively
        through calls, skipping nested defs)."""
        blocking: dict = {}
        checkpoints = False
        stack = list(loop.body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(node, ast.Call):
                if self._is_checkpoint(node):
                    checkpoints = True
                else:
                    hit = self._direct_blocking(mi, node, socket_locals)
                    if hit is not None:
                        if not self._suppressed_blocking(
                                mi.ms, node.lineno, fn.lineno):
                            blocking.setdefault(
                                hit[0], f"{mi.ms.rel}:{node.lineno} "
                                        f"via {hit[1]}")
                    else:
                        suppressed = self._suppressed_blocking(
                            mi.ms, node.lineno, fn.lineno)
                        for ck in self.res._resolve_call(
                                mi, ci, node, local_insts):
                            sub = self.effects(ck)
                            if sub.checkpoints:
                                checkpoints = True
                            if suppressed:
                                continue
                            for kind, where in sub.blocking.items():
                                blocking.setdefault(
                                    kind, f"{mi.ms.rel}:{node.lineno} "
                                          f"via {ck[1]}.{ck[2]} ({where})")
            stack.extend(ast.iter_child_nodes(node))
        return blocking, checkpoints

    def _check_loops(self, mi, ci, fn, key):
        if key in self.thread_targets:
            return  # daemon service loop: not query context
        if mi.ms.dotted.startswith("analysis."):
            # the analyzers are boundary-pinned to zero package deps —
            # they CANNOT import lifecycle, so there is no QueryContext
            # to observe; they run offline, never on an engine thread
            return
        ms = mi.ms
        local_insts = self.res._local_instances(mi, fn)
        socket_locals = self._socket_locals(mi, fn)
        for node in self._walk_body(fn):
            if not isinstance(node, (ast.While, ast.For)):
                continue
            if self._loop_exempt(ms, node.lineno):
                continue
            blocking, checkpoints = self._loop_effects(
                mi, ci, fn, node, local_insts, socket_locals)
            hits = {k: w for k, w in blocking.items() if k in _LOOP_KINDS}
            if hits and not checkpoints:
                kind = sorted(hits)[0]
                self.findings.append(Finding(
                    "error", "checkpoint-free-blocking-loop",
                    f"{ms.rel}:{node.lineno}",
                    f"{key[1]}.{key[2]} loops over a blocking "
                    f"{kind} effect ({hits[kind]}) with no reachable "
                    f"cancellation checkpoint — a KILL/deadline cannot "
                    f"land between iterations; call "
                    f"lifecycle.checkpoint(stage) in the body or tag "
                    f"the loop `# lint: checkpoint-exempt <reason>`"))

    # === contract 3: no blocking under lock ==================================
    def _check_blocking_under_lock(self, mi, ci, fn, key):
        ms = mi.ms
        local_insts = self.res._local_instances(mi, fn)
        socket_locals = self._socket_locals(mi, fn)
        locks = self.idx.all_locks(ci) if ci is not None else {}
        held0 = set()
        for h in concur_check._parse_holds(ms.line(fn.lineno)):
            if h in locks:
                kind, defining = locks[h]
                held0.add(f"{defining}.{h}")

        seen: set = set()

        def flag(node, kind, where, held):
            if self._suppressed_blocking(ms, node.lineno, fn.lineno):
                return
            if (node.lineno, kind) in seen:
                return  # nested calls on one line: one finding is enough
            seen.add((node.lineno, kind))
            self.findings.append(Finding(
                "error", "blocking-under-lock",
                f"{ms.rel}:{node.lineno}",
                f"{key[1]}.{key[2]} performs a blocking {kind} effect "
                f"({where}) while holding {sorted(held)} — move the "
                f"expensive work outside the lock (the DeviceCache "
                f"rule) or tag the site `# lint: blocking-ok <reason>`"))

        def visit(node, held):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acq = set()
                for item in node.items:
                    ln = self.res._lock_node_of_expr(
                        mi, ci, item.context_expr, local_insts)
                    if ln is not None:
                        acq.add(ln[0])
                    visit(item.context_expr, held)
                for child in node.body:
                    visit(child, held | acq)
                return
            if isinstance(node, ast.Call) and held:
                hit = self._direct_blocking(mi, node, socket_locals)
                if hit is not None:
                    if hit[0] in _UNDER_LOCK_KINDS:
                        flag(node, hit[0],
                             f"{ms.rel}:{node.lineno} via {hit[1]}", held)
                else:
                    for ck in self.res._resolve_call(mi, ci, node,
                                                     local_insts):
                        sub = self.effects(ck)
                        for kind, where in sub.blocking.items():
                            if kind in _UNDER_LOCK_KINDS:
                                flag(node, kind,
                                     f"{ck[1]}.{ck[2]} ({where})", held)
                                break
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for child in fn.body:
            visit(child, held0)

    # === contract 4: daemon-thread + worker-process lifecycle ================
    def _owner_has_stop(self, mi, ci, methods) -> bool:
        """The enclosing class (or module) exposes one of `methods` — the
        reachable teardown contract 4 requires of thread/process owners."""
        if ci is not None:
            return any(set(c.methods) & methods
                       for c in self.idx.mro(ci))
        return bool(set(self.idx.modules[mi.ms.dotted].functions) & methods)

    def _check_procs(self, mi, ci, fn, key):
        """subprocess.Popen is a process-handle acquire: the spawning
        owner must expose a stop/terminate path (a worker a coordinator
        cannot kill wedges shutdown exactly like a non-daemon thread,
        plus leaks a whole interpreter)."""
        ms = mi.ms
        for node in self._walk_body(fn):
            if not isinstance(node, ast.Call):
                continue
            a = self._direct_acquire(mi, node, fn.name)
            if a is None or a[0] != "proc":
                continue
            self.stats["procs"] += 1
            if not self._owner_has_stop(mi, ci, _PROC_STOP_METHODS):
                self.findings.append(Finding(
                    "error", "proc-without-stop",
                    f"{ms.rel}:{node.lineno}",
                    f"{key[1]}.{key[2]} spawns a subprocess but its "
                    f"owner exposes no stop/close/shutdown/terminate/"
                    f"kill — pair every Popen with a reachable "
                    f"termination path (the ClusterRuntime.stop "
                    f"pattern: SHUTDOWN, then terminate, then kill)"))

    def _check_threads(self, mi, ci, fn, key):
        ms = mi.ms
        for node in self._walk_body(fn):
            if not (isinstance(node, ast.Call)
                    and self._is_thread_ctor(mi, node)):
                continue
            self.stats["threads"] += 1
            daemon = None
            for kw in node.keywords:
                if kw.arg == "daemon":
                    daemon = kw.value
            if not (isinstance(daemon, ast.Constant)
                    and daemon.value is True):
                self.findings.append(Finding(
                    "error", "non-daemon-thread",
                    f"{ms.rel}:{node.lineno}",
                    f"{key[1]}.{key[2]} starts a thread without a "
                    f"literal daemon=True — a non-daemon thread wedges "
                    f"process shutdown (and a killed worker's unwind)"))
            owner = None
            if ci is not None:
                owner = ci
            stop_ok = False
            if owner is not None:
                for c in self.idx.mro(owner):
                    if set(c.methods) & _STOP_METHODS:
                        stop_ok = True
                        break
            else:
                stop_ok = bool(set(self.idx.modules[mi.ms.dotted].functions)
                               & _STOP_METHODS)
            if not stop_ok:
                self.findings.append(Finding(
                    "error", "thread-without-stop",
                    f"{ms.rel}:{node.lineno}",
                    f"{key[1]}.{key[2]} starts a thread but its owner "
                    f"exposes no stop/close/shutdown — pair every "
                    f"thread start with a reachable stop (the "
                    f"MetricsHistory ensure_started/stop pattern)"))

    # --- driver ---------------------------------------------------------------
    def run(self):
        for mi in self.idx.modules.values():
            for ci, fn in self._callables(mi):
                key = ("meth", ci.qual, fn.name) if ci is not None \
                    else ("func", mi.ms.dotted, fn.name)
                self.stats["functions"] += 1
                eff = self.effects(key)
                self.stats["blocking_sites"] += len(eff.blocking)
                if eff.checkpoints:
                    self.stats["checkpoint_sites"] += 1
                self._check_acquires(mi, ci, fn, key)
                self._check_loops(mi, ci, fn, key)
                self._check_blocking_under_lock(mi, ci, fn, key)
                self._check_threads(mi, ci, fn, key)
                self._check_procs(mi, ci, fn, key)


def check_sources(sources) -> concur_check.Report:
    idx = concur_check._Index(sources)
    an = _EffectAnalyzer(idx)
    an.run()
    order = {"error": 0, "warn": 1}
    an.findings.sort(key=lambda f: (order[f.severity], f.where, f.rule))
    return concur_check.Report(findings=an.findings, stats=dict(an.stats))


def check_package(repo: str | None = None) -> concur_check.Report:
    return check_sources(astwalk.package_sources(repo))


def check_fixture(src: str,
                  rel: str = "starrocks_tpu_torch/fixture.py"
                  ) -> concur_check.Report:
    """Golden bad-fixture entry: analyze one in-memory module."""
    return check_sources([astwalk.parse_fixture(src, rel)])


def acquire_sites(sources) -> list:
    """Every statically discovered acquire site (chaos_fuzz cross-checks
    these against failpoint-covered unwind paths)."""
    idx = concur_check._Index(sources)
    an = _EffectAnalyzer(idx)
    an.run()
    return sorted(an.acquire_sites,
                  key=lambda s: (s.rel, s.line, s.kind))
