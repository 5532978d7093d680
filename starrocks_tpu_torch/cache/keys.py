"""Cache-key construction for the two-tier query cache.

Every function here is a KEY BUILDER: the values it folds into a key are
the complete set of inputs that may change the cached artifact: config
knobs enter keys only through `config.trace_key()` (declared trace=True at
their define site) or OPT_KEY_KNOBS, and data versions are validated ON HIT
against the catalog's data epochs + storage content tokens
(storage/catalog.py `data_version`), so a table mutated through ANY path —
session DML or direct TabletStore calls — misses instead of serving stale
bytes.

A port of the JAX package's cache/keys.py. OPT_KEY_KNOBS is shared with
the optimized-plan cache and with `analysis/key_check.py`, whose
`check_cache_reads` audits the knob read-set of every execution whose
result gets cached (Executor._verify_cache_reads: strict mode fails on an
escapee, warn mode declines to cache).
"""

from __future__ import annotations

import os

from ..analysis.key_check import OPT_KEY_KNOBS  # noqa: F401 (re-export)
from ..runtime.config import config


def full_result_key(plan) -> tuple:
    """Structural key of the full-result tier: the analyzed logical plan
    (frozen hashable tree), every trace-declared knob value, the plan-
    shaping optimizer knobs, and the UDF registry epoch. Data versions are
    deliberately NOT part of the key — they are validated at lookup time
    (see QueryCache.lookup_result), which lets one INSERT invalidate
    without enumerating every cached plan shape."""
    from ..runtime.udf import registry_epoch

    opt_vals = tuple((k, config.get(k)) for k in OPT_KEY_KNOBS)
    return (plan, config.trace_key(), opt_vals, registry_epoch())


def version_map(catalog, tables) -> dict:
    """{table: data version token} for the given table names — stored with
    a full-result entry and re-validated on every hit."""
    return {t: catalog.data_version(t) for t in sorted(tables)}


def fragment_key(agg, scan_chain, scan) -> tuple:
    """Fingerprint of a cacheable scan->filter/project->aggregate fragment
    (partial-aggregation tier). The fragment nodes are frozen plan
    dataclasses; trace knobs join because partial-state VALUES are produced
    by traced kernels those knobs steer."""
    from ..runtime.udf import registry_epoch

    return (agg, tuple(scan_chain), scan, config.trace_key(),
            registry_epoch())


def fragment_program_key(n_shards: int, plan, frag) -> tuple:
    """Program-bucket key of ONE fragment of a fragment-IR plan. The whole
    logical plan pins the query shape; the fingerprint pins the fragment's
    identity WITHIN it: its ordinal, the declared placements (its own
    out_mode plus the boundary mode each upstream feed arrives in), the
    sink flag, and the output-edge exchange declaration. Placement is part
    of the key — not just the fid — because the recorder may legally emit
    a different exchange plan for the same subtree when scan layouts
    change, and capacities learned for the old placement must miss. Trace
    knobs and the UDF epoch join in DeviceCache.program_bucket."""
    ex = frag.exchange
    placement = (
        frag.out_mode,
        tuple(sorted(
            (slot, mode) for slot, mode in frag.boundary.values())),
        frag.sink,
        None if ex is None else (ex.kind, ex.payload, ex.out_mode),
    )
    return ("frag", n_shards, plan, frag.fid, placement)


def segment_version(store, table: str, fmeta: dict):
    """Identity token of one manifest data file, or None when the file is
    unreadable (a vanished segment is never cached against). Rowset files
    are immutable, so (name, rows, delete-vector, live columns, stat
    signature) pins the content: upserts move the delvec, linked schema
    changes move the cols list, and a recreated table reusing a file name
    changes the mtime/size signature."""
    path = os.path.join(store._tdir(table), fmeta["file"])
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (
        fmeta["file"], fmeta["rows"],
        tuple(fmeta.get("delvec") or ()),
        tuple(fmeta.get("cols") or ()),
        st.st_mtime_ns, st.st_size,
    )
