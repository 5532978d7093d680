"""The device-free modules of the last slice are the reference's text.

ingest/ (the stream-load and routine-load plane), storage/external.py and
analysis/ are copies of the JAX package's modules with only their imports
changed. Where a definition had to differ, ADAPTED names it: the module
docstrings (each says what the port changed), the package name the static
gates point at, the torch device waits of effects_check, the readers the
external tables go to instead of pyarrow, with the merge and column
builders that replace pyarrow's concat_tables and from_arrow, and the
poll loop's tick that the port's tests drive. analysis/trace_check.py is
not a copy: the jaxpr audit is re-derived for eager torch (its docstring
says check by check).
"""

from __future__ import annotations

import ast
import difflib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _lock_witness_acyclic():
    """Teardown gate of the port's runtime lock-witness: the order graph
    of every lock this module's tests took has no cycle."""
    yield
    from starrocks_tpu_torch import lockdep as _lockdep

    cycles = _lockdep.WITNESS.order_cycles()
    assert not cycles, _lockdep.WITNESS.render(cycles)

ADAPTED = {
    "ingest/poller.py": {"_run", "poll_once"},
    "storage/external.py": {"_open", "_file_schema", "_file_rows",
                            "_read_file", "_read_files", "__init__",
                            "schema", "_load", "stale", "_THREADS",
                            "_merged_specs", "_build", "_bitmap", "_array",
                            "_as_text"},  # _read_file: the reference's
    # pyarrow read, which _read_files (the merge of concat_tables) and the
    # builders of from_arrow's BITMAP and ARRAY columns replace
    "analysis/__init__.py": {"logger"},
    "analysis/astwalk.py": {"_PKG", "ModuleSrc", "package_sources",
                            "parse_fixture"},
    "analysis/boundary_check.py": {"module_imports", "external_imports",
                                   "load_manifest", "check_imports"},
    "analysis/concur_check.py": {"_collect_module", "_collect_import_from",
                                 "check_fixture"},
    "analysis/effects_check.py": {"_device_wait", "_numpy_made",
                                  "_direct_blocking", "check_fixture"},
    "analysis/key_check.py": {"check_cache_reads"},
}
COPIES = ["ingest/__init__.py", "ingest/labels.py", "ingest/plane.py",
          "ingest/poller.py", "storage/external.py", "analysis/__init__.py",
          "analysis/astwalk.py", "analysis/boundary_check.py",
          "analysis/concur_check.py", "analysis/effects_check.py",
          "analysis/key_check.py", "analysis/plan_check.py"]


def _without(text: str, names: set) -> list:
    """The module's lines with its docstring and the named definitions
    (functions, classes, assignments to a name) blanked."""
    tree = ast.parse(text)
    drop = set()
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and isinstance(
            getattr(body[0], "value", None), ast.Constant):
        drop.update(range(body[0].lineno, body[0].end_lineno + 1))
    for node in ast.walk(tree):
        hit = False
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            hit = node.name in names
        elif isinstance(node, ast.Assign):
            hit = any(isinstance(t, ast.Name) and t.id in names
                      for t in node.targets)
        if hit:
            first = min([node.lineno] + [d.lineno for d in getattr(
                node, "decorator_list", ())])
            drop.update(range(first, node.end_lineno + 1))
    return [ln for i, ln in enumerate(text.splitlines(), 1)
            if i not in drop]


@pytest.mark.parametrize("mod", COPIES)
def test_module_differs_from_the_reference_only_in_imports(mod):
    with open(os.path.join(REPO, "starrocks_tpu", mod)) as f:
        ref = f.read()
    with open(os.path.join(REPO, "starrocks_tpu_torch", mod)) as f:
        port = f.read()
    names = ADAPTED.get(mod, set())
    changed = [ln[1:].strip() for ln in difflib.unified_diff(
        _without(ref, names), _without(port, names), lineterm="", n=0)
        if ln[:1] in "+-" and not ln.startswith(("+++", "---"))]
    assert all(ln.startswith(("import ", "from ")) or not ln
               for ln in changed), changed


def test_every_module_of_the_reference_is_ported():
    """comm -23 of the two packages' module lists: what the port lacks is
    only ops/pallas_kernels.py, whose five kernels are csrc/*.cu."""
    def modules(pkg):
        root = os.path.join(REPO, pkg)
        out = set()
        for d, dirs, files in os.walk(root):
            dirs[:] = [x for x in dirs if x != "__pycache__"]
            out |= {os.path.relpath(os.path.join(d, f), root)
                    for f in files if f.endswith(".py")}
        return out

    missing = modules("starrocks_tpu") - modules("starrocks_tpu_torch")
    assert missing == {os.path.join("ops", "pallas_kernels.py")}
    kernels = {f for f in os.listdir(os.path.join(
        REPO, "starrocks_tpu_torch", "csrc")) if f.endswith(".cu")}
    assert kernels == {"hash_table.cu", "probe_searchsorted.cu",
                       "segment_sum.cu", "topn_select.cu"}
