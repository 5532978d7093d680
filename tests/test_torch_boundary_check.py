"""The port's boundary manifest (starrocks_tpu_torch/
module_boundary_manifest.json) and its forbid rule on outside packages.

The manifest is derived from the port's real import graph and keeps the
JAX package's layer edges where the port's layering matches; its
`external_forbidden` list holds jax, jaxlib, pyarrow and the JAX package
for every unit, so the port's first working rule (torch and numpy only) is
a check: a planted import of any of them is caught, wherever it sits.
"""

from __future__ import annotations

import json
import os

import pytest

from starrocks_tpu_torch.analysis import astwalk, boundary_check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "pyarrow", "starrocks_tpu")


@pytest.fixture(scope="module", autouse=True)
def _lock_witness_acyclic():
    """Teardown gate of the port's runtime lock-witness: the order graph
    of every lock this module's tests took has no cycle."""
    yield
    from starrocks_tpu_torch import lockdep as _lockdep

    cycles = _lockdep.WITNESS.order_cycles()
    assert not cycles, _lockdep.WITNESS.render(cycles)


def _planted(rel: str, src: str):
    """Empty stand-ins of the port's modules (their names resolve import
    targets; the real package's own check is below) plus one planted
    module."""
    stubs = [astwalk.parse_fixture("", ms.rel)
             for ms in astwalk.package_sources(REPO)]
    return stubs + [astwalk.parse_fixture(src, rel)]


def test_manifest_forbids_the_reference_stack_in_every_unit():
    m = boundary_check.load_manifest()
    assert m["package"] == "starrocks_tpu_torch"
    assert set(FORBIDDEN) <= set(m["external_forbidden"])
    # no unit or module rule may allow-list a forbidden package back
    rules = list(m["units"].values()) + list(m["module_rules"].values())
    for r in rules:
        assert not set(r.get("external", [])) & set(FORBIDDEN), r


@pytest.mark.parametrize("rel", [
    "starrocks_tpu_torch/runtime/planted.py",   # top of the stack
    "starrocks_tpu_torch/ops/planted.py",
    "starrocks_tpu_torch/storage/planted.py",
    "starrocks_tpu_torch/analysis/planted.py",
])
@pytest.mark.parametrize("stmt,target", [
    ("import jax\n", "jax"),
    ("import jax.numpy as jnp\n", "jax.numpy"),
    ("from jax import lax\n", "jax"),
    ("def f():\n    import jaxlib\n    return jaxlib\n", "jaxlib"),
    ("import pyarrow.parquet as pq\n", "pyarrow.parquet"),
    ("from starrocks_tpu.runtime.session import Session\n",
     "starrocks_tpu.runtime.session"),
    ("import starrocks_tpu\n", "starrocks_tpu"),
])
def test_planted_forbidden_import_is_caught(rel, stmt, target):
    fs = boundary_check.check_package(
        REPO, sources=_planted(rel, stmt))
    hits = [f for f in fs if f.rule == "forbidden-external"]
    assert len(hits) == 1, fs
    assert hits[0].severity == "error" and repr(target) in hits[0].message
    assert hits[0].where.startswith(rel)


def test_the_port_itself_is_no_forbidden_external():
    """`import starrocks_tpu_torch...` is the package, not the JAX one."""
    fs = boundary_check.check_package(REPO, sources=_planted(
        "starrocks_tpu_torch/runtime/planted.py",
        "import starrocks_tpu_torch.runtime.config\n"))
    assert fs == []


def test_real_package_clean_and_every_unit_used():
    """Zero findings over the port: no forbidden or undeclared edge, and
    no stale unit (every unit the manifest declares holds a module)."""
    assert [str(f) for f in boundary_check.check_package(REPO)] == []


def test_manifest_keeps_the_reference_edges():
    """Every layer edge the JAX package's manifest allows, the port's
    allows too, with the same forbids; the port's additions are the two
    edges its own layering needs (the kernel wrappers' witnessed lock, the
    hash placement's host partitioner)."""
    with open(os.path.join(REPO, "module_boundary_manifest.json")) as f:
        ref = json.load(f)
    port = boundary_check.load_manifest()
    extra = {"ops": {"lockdep"}, "parallel": {"native"}}
    assert set(port["units"]) == set(ref["units"])
    for unit, rule in ref["units"].items():
        mine = port["units"][unit]
        assert set(mine.get("allow", [])) == (
            set(rule.get("allow", [])) | extra.get(unit, set())), unit
        assert set(mine.get("forbid", [])) == set(rule.get("forbid", [])), unit
    assert set(port["module_rules"]) == set(ref["module_rules"])
    for mod, rule in ref["module_rules"].items():
        assert port["module_rules"][mod]["allow"] == rule["allow"], mod
