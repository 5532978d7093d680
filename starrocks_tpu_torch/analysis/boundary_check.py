"""Module-boundary manifest gate: the package's import contract.

Reference behavior: be/module_boundary_manifest.json — the authoritative
BE layer map (SURVEY §1): 52 modules with explicit allowed-dependency
edges, enforced by a build-time checker instead of reviewers. This is the
engine-level analog: ``starrocks_tpu_torch/module_boundary_manifest.json``
declares, per unit of the package (each subpackage, plus each root module
like ``native``/``lockdep``/``types``), which package-internal import
prefixes are allowed and which are explicitly forbidden; this pass builds
the real import graph from the shared AST walk and enforces the contract.

Semantics — longest-prefix-wins over allow ∪ forbid:
- an internal import target (dotted, package-relative: ``runtime.config``,
  ``ops``, ``native``) is matched against the unit's ``allow`` and
  ``forbid`` prefix lists at dotted-segment boundaries;
- the LONGEST matching prefix decides, so ``forbid: ["runtime"]`` +
  ``allow: ["runtime.config"]`` reads "ops/ must not import runtime/ —
  except the config registry";
- no matching prefix at all = an UNDECLARED dependency: also a violation
  (the manifest must name every edge, so new coupling is a reviewed
  manifest diff, not an accident);
- ``allow: ["*"]`` marks a top-of-stack unit (runtime) that may import
  anything;
- ``module_rules`` pins single files tighter than their unit — the
  static analyzers (astwalk/concur_check/boundary_check) import nothing
  they audit, and the gate proves it.

Import-target resolution: ``from ..runtime import lifecycle`` counts as
``runtime.lifecycle`` when that module exists (an attribute import like
``from ..column import Chunk`` counts as ``column``); ``import
starrocks_tpu_torch.x.y`` counts as ``x.y``.

External imports: most (numpy, stdlib) are out of scope. The manifest's
``external_governed`` list names externals whose reach is part of the
layer contract — torch (the device dependency: the static gates and the
ingest plane stay importable without it) and socket/socketserver/http
(wire protocol: the runtime service modules only). A governed external
import must match the unit's (or module_rule's) ``external`` allow-prefix
list; nested/lazy imports count too. ``external_forbidden`` names what no
unit may import at all — the port's first working rule: jax, jaxlib,
pyarrow and the JAX package (``starrocks_tpu``).

A copy of the JAX package's analysis/boundary_check.py, pointed at the
port (the manifest's path, the package name) and given the forbidden
list. Standalone-loadable like concur_check.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os

try:
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

MANIFEST_NAME = "module_boundary_manifest.json"


@dataclasses.dataclass(frozen=True)
class Finding:
    severity: str
    rule: str
    where: str
    message: str

    def __str__(self):
        return f"{self.where}: [{self.rule}] {self.severity}: {self.message}"


def load_manifest(repo: str | None = None) -> dict:
    repo = repo or astwalk.repo_root()
    with open(os.path.join(repo, astwalk._PKG, MANIFEST_NAME)) as f:
        return json.load(f)


def unit_of(rel_or_dotted: str) -> str:
    """Manifest unit of a module: its top-level subpackage, or the root
    module's own name ('' / '__init__' -> '(root)')."""
    d = rel_or_dotted
    if d.endswith(".py"):
        parts = d[:-3].split(os.sep)
        d = ".".join(parts[1:])
        if d.endswith("__init__"):
            d = d[:-len("__init__")].rstrip(".")
    head = d.split(".")[0] if d else ""
    return head or "(root)"


def module_imports(ms, mod_names) -> list:
    """[(lineno, dotted internal target)] for one module."""
    if os.path.basename(ms.rel) == "__init__.py":
        pkg = ms.dotted
    else:
        pkg = ms.dotted.rsplit(".", 1)[0] if "." in ms.dotted else ""
    out = []
    for node in ast.walk(ms.tree):
        if isinstance(node, ast.ImportFrom):
            if node.level:
                parts = pkg.split(".") if pkg else []
                if node.level > 1:
                    if node.level - 1 > len(parts):
                        continue  # escapes the package: not internal
                    parts = parts[:len(parts) - (node.level - 1)]
                base = ".".join(parts + (node.module.split(".")
                                         if node.module else []))
            elif node.module and (
                    node.module.split(".")[0] == astwalk._PKG):
                base = node.module[len(astwalk._PKG):].lstrip(".")
            else:
                continue  # external
            if base and base not in mod_names and not any(
                    m.startswith(base + ".") for m in mod_names):
                continue  # relative import that resolved outside
            for a in node.names:
                sub = f"{base}.{a.name}" if base else a.name
                if sub in mod_names:
                    out.append((node.lineno, sub))  # submodule import
                elif base:
                    out.append((node.lineno, base))  # attribute import
                # `from . import <attr-of-root>` with no such module:
                # counts as the root package itself -> nothing to check
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] == astwalk._PKG:
                    d = a.name[len(astwalk._PKG):].lstrip(".")
                    if d:
                        out.append((node.lineno, d))
    return out


def external_imports(ms) -> list:
    """[(lineno, dotted external target)] for one module — absolute imports
    that do not resolve into the package (nested function-level imports
    included: a lazy ``import socket`` is still a socket dependency)."""
    out = []
    for node in ast.walk(ms.tree):
        if isinstance(node, ast.ImportFrom):
            if node.level or not node.module:
                continue  # relative = internal
            if node.module.split(".")[0] == astwalk._PKG:
                continue
            out.append((node.lineno, node.module))
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] == astwalk._PKG:
                    continue
                out.append((node.lineno, a.name))
    return out


def _match(target: str, prefixes) -> int:
    """Length (in segments) of the longest prefix matching target at
    dotted boundaries; -1 if none. '*' matches everything at length 0."""
    best = -1
    tseg = target.split(".")
    for p in prefixes:
        if p == "*":
            best = max(best, 0)
            continue
        pseg = p.split(".")
        if tseg[:len(pseg)] == pseg:
            best = max(best, len(pseg))
    return best


def check_imports(manifest: dict, sources) -> list:
    """Enforce the manifest over parsed sources -> findings."""
    units = manifest.get("units", {})
    module_rules = manifest.get("module_rules", {})
    mod_names = astwalk.module_names(sources)
    findings = []
    seen_units = set()
    for ms in sources:
        unit = unit_of(ms.rel)
        seen_units.add(unit)
        rule = units.get(unit)
        if rule is None:
            findings.append(Finding(
                "error", "unit-missing", ms.rel,
                f"unit {unit!r} has no entry in {MANIFEST_NAME}: every "
                f"package unit must declare its import contract"))
            continue
        # tighter per-file override (the static analyzers' zero-deps rule)
        pkg_rel = ms.rel.split(os.sep, 1)[1] if os.sep in ms.rel else ms.rel
        override = module_rules.get(pkg_rel)
        allow = (override or rule).get("allow", [])
        forbid = (override or rule).get("forbid", [])
        scope = f"module_rules[{pkg_rel!r}]" if override else f"unit {unit!r}"
        banned = manifest.get("external_forbidden", [])
        for lineno, target in external_imports(ms):
            if _match(target, banned) >= 0:
                findings.append(Finding(
                    "error", "forbidden-external", f"{ms.rel}:{lineno}",
                    f"import of {target!r}: the manifest's "
                    f"external_forbidden list holds it for every unit "
                    f"(no allow list overrides it)"))
        governed = manifest.get("external_governed", [])
        if governed:
            ext_allow = (override or rule).get("external", [])
            for lineno, target in external_imports(ms):
                if _match(target, governed) < 0:
                    continue  # numpy/stdlib: out of contract scope
                if _match(target, ext_allow) < 0:
                    findings.append(Finding(
                        "error", "external-import", f"{ms.rel}:{lineno}",
                        f"governed external {target!r} is not allow-listed "
                        f"for {scope}: add it to the manifest's 'external' "
                        f"list (a reviewed contract change) or drop the "
                        f"dependency"))
        for lineno, target in module_imports(ms, mod_names):
            a = _match(target, allow)
            f = _match(target, forbid)
            if f > a:
                findings.append(Finding(
                    "error", "forbidden-import", f"{ms.rel}:{lineno}",
                    f"import of {target!r} is FORBIDDEN for {scope} "
                    f"(matched forbid prefix; see {MANIFEST_NAME})"))
            elif a < 0:
                findings.append(Finding(
                    "error", "undeclared-import", f"{ms.rel}:{lineno}",
                    f"import of {target!r} is not declared for {scope}: "
                    f"add it to the manifest's allow list (a reviewed "
                    f"contract change) or remove the dependency"))
    for unit in sorted(set(units) - seen_units):
        findings.append(Finding(
            "warn", "stale-unit", MANIFEST_NAME,
            f"manifest declares unit {unit!r} but no module maps to it"))
    return findings


def check_package(repo: str | None = None, sources=None) -> list:
    repo = repo or astwalk.repo_root()
    sources = sources or astwalk.package_sources(repo)
    return check_imports(load_manifest(repo), sources)
