"""One shared AST walk over the package, for every static gate.

tools/src_lint.py, analysis/concur_check.py and analysis/boundary_check.py
all need (source text, split lines, parsed tree) for every module in
starrocks_tpu_torch/. Parsing ~70 modules is cheap but not free, and doing it
once per checker triples the cost of the pre-pytest gate — so this module
is the single parse point, with a per-process cache keyed by (path, mtime,
size).

Deliberately stdlib-only and loadable STANDALONE (by file path, via
importlib) so a gate never imports the package it checks (the port's
``__init__`` pulls torch, and a lint that needs a torch install to run
cannot gate a docs-only checkout). concur_check and
boundary_check fall back to the same path-load when executed outside the
package (see their import headers).
"""

from __future__ import annotations

import ast
import dataclasses
import os

_PKG = "starrocks_tpu_torch"


@dataclasses.dataclass
class ModuleSrc:
    """One parsed module: everything a checker needs, parsed exactly once."""

    rel: str          # repo-relative path, e.g. starrocks_tpu_torch/ops/join.py
    path: str         # absolute path
    src: str
    lines: list       # src.splitlines() — for comment-annotation checks
    tree: ast.AST
    dotted: str       # package-internal dotted name: "ops.join",
    #                   "runtime" (a subpackage __init__), "native"
    #                   (a root module), "" (the package __init__)

    def line(self, lineno: int) -> str:
        """1-based source line ('' past EOF)."""
        return self.lines[lineno - 1] if 0 < lineno <= len(self.lines) else ""


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def _dotted(rel: str) -> str:
    parts = rel[:-len(".py")].split(os.sep)
    assert parts[0] == _PKG
    parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


_cache: dict = {}  # abs path -> (mtime_ns, size, ModuleSrc)


def load_module(path: str, repo: str) -> ModuleSrc:
    st = os.stat(path)
    hit = _cache.get(path)
    if hit is not None and hit[0] == st.st_mtime_ns and hit[1] == st.st_size:
        return hit[2]
    with open(path) as f:
        src = f.read()
    rel = os.path.relpath(path, repo)
    # a SyntaxError here propagates: every gate fails loudly on an
    # unparseable module rather than silently skipping it
    ms = ModuleSrc(rel=rel, path=path, src=src, lines=src.splitlines(),
                   tree=ast.parse(src, filename=rel), dotted=_dotted(rel))
    _cache[path] = (st.st_mtime_ns, st.st_size, ms)
    return ms


def package_sources(repo: str | None = None) -> list:
    """Every .py module under starrocks_tpu_torch/, sorted by rel path."""
    repo = repo or repo_root()
    pkg = os.path.join(repo, _PKG)
    out = []
    for root, dirs, files in os.walk(pkg):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for fn in sorted(files):
            if fn.endswith(".py"):
                out.append(load_module(os.path.join(root, fn), repo))
    return out


def parse_fixture(src: str,
                  rel: str = "starrocks_tpu_torch/fixture.py") -> ModuleSrc:
    """Uncached parse of an in-memory source (golden bad-fixture tests)."""
    return ModuleSrc(rel=rel, path=rel, src=src, lines=src.splitlines(),
                     tree=ast.parse(src, filename=rel), dotted=_dotted(rel))


def module_names(sources) -> set:
    """The dotted names of every module in the package (import-target
    resolution: `from ..runtime import lifecycle` names a module iff
    'runtime.lifecycle' is in this set)."""
    return {ms.dotted for ms in sources}
