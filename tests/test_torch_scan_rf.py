"""Two-phase scan pruning by runtime filters in the PyTorch port
(sql/scan_rf.py, runtime/executor.py `_scan_runtime_filters`,
`DeviceCache.pruned_handle_for`) against the JAX package's.

The three `test_scan_rf_*` cases of tests/test_runtime_filters.py run
through both Sessions over their own data_dirs: the rows and the
`rf_segments_pruned` counter must be equal, with pruning on and off, and a
pruned snapshot must not survive a change to the build side.
"""

import pytest

from torch_sql_scripts import (  # noqa: F401 (fixture)
    _default_knobs, run_both, sessions,
)


def _pruned(s):
    """rf_segments_pruned of the session's last query, or None."""
    c = s.last_profile.counters.get("rf_segments_pruned")
    return None if c is None else c[0]


def _fact_dim(js, ts, bases, n):
    script = ["CREATE TABLE fact (k BIGINT, v BIGINT)",
              "CREATE TABLE dim (k BIGINT, attr VARCHAR)"]
    for base in bases:
        vals = ", ".join(f"({base + i}, {i})" for i in range(n))
        script.append(f"INSERT INTO fact VALUES {vals}")
    run_both(js, ts, script)


def test_scan_rf_prunes_segments_and_matches_off(tmp_path):
    js, ts = sessions(tmp_path)
    _fact_dim(js, ts, (0, 1000, 2000, 3000), 100)
    run_both(js, ts, ["INSERT INTO dim VALUES (2005, 'x'), (2010, 'x'), "
                      "(500, 'y')"])
    q = ("SELECT sum(f.v) AS sv, count(*) AS c "
         "FROM fact f JOIN dim d ON f.k = d.k WHERE d.attr = 'x'")
    out = run_both(js, ts, [q])
    assert out[0][1] == [(15, 2)]
    assert _pruned(ts) == _pruned(js) and _pruned(ts) > 0
    out = run_both(js, ts, ["SET runtime_filter_strategy='off'", q])
    assert _pruned(ts) is None and _pruned(js) is None
    assert out[1][1] == [(15, 2)]


def test_scan_rf_empty_build_prunes_everything(tmp_path):
    js, ts = sessions(tmp_path)
    _fact_dim(js, ts, (0, 1000), 50)
    run_both(js, ts, ["INSERT INTO dim VALUES (10, 'y')"])
    q = ("SELECT count(*) AS c FROM fact f JOIN dim d ON f.k = d.k "
         "WHERE d.attr = 'nope'")
    out = run_both(js, ts, [q])
    assert out[0][1] == [(0,)]
    assert _pruned(ts) == _pruned(js) == 2


def test_scan_rf_respects_dml_invalidation(tmp_path):
    js, ts = sessions(tmp_path)
    _fact_dim(js, ts, (0, 1000, 2000), 50)
    q = ("SELECT count(*) AS c FROM fact f JOIN dim d ON f.k = d.k "
         "WHERE d.attr = 'x'")
    out = run_both(js, ts, ["INSERT INTO dim VALUES (2005, 'x')", q])
    assert out[1][1] == [(1,)] and _pruned(ts) == _pruned(js) == 2
    # the pruned snapshot is cached under the probe table's name, and a
    # change to that table drops it
    assert any(k[0] == "fact" for k in ts.cache._rfscan)
    out = run_both(js, ts, ["INSERT INTO fact VALUES (2005, 7)"])
    assert not any(k[0] == "fact" for k in ts.cache._rfscan)
    out = run_both(js, ts, [
        q,
        "INSERT INTO dim VALUES (5, 'x')", q,  # a key in a pruned file
    ])
    assert [out[0][1], out[2][1]] == [[(2,)], [(3,)]]
    assert _pruned(ts) == _pruned(js)


@pytest.mark.parametrize("strategy", ["auto", "minmax", "bloom"])
def test_scan_rf_in_memory_tables_never_prune(strategy):
    """Only stored tables have zonemaps: in-memory probes load whole."""
    js, ts = sessions()
    _fact_dim(js, ts, (0, 1000), 20)
    out = run_both(js, ts, [
        f"SET runtime_filter_strategy='{strategy}'",
        "INSERT INTO dim VALUES (1005, 'x')",
        "SELECT count(*) FROM fact f JOIN dim d ON f.k = d.k "
        "WHERE d.attr = 'x'"])
    assert out[-1][1] == [(1,)]
    assert _pruned(ts) is None and not ts.cache._rfscan
