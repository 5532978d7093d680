"""The port's TabletStore (storage/store.py: parquet rowset files written
and read without pyarrow, manifest, edit log, image) against the JAX
package's (parquet through pyarrow), on the same scripts.

Mirrors tests/test_storage.py's store cases (not CSV, the native kernels,
the compilation cache or the grace join): restart round trips with NULLs
and strings, zonemap pruning with equal `last_scan_stats`, range
partitions, partition pruning and the bound violation, the primary-key
delta path with delete vectors equal to the reference's, VARCHAR/DATE
keys, compaction, ALTER add/drop/re-add, the image checkpoint and a
concurrent log, backup and restore, and manifests equal to the reference's
(tests/test_torch_store_format.py opens each package's directory in the
other). The vectorised primary index is held to
the reference's dict index on hypothesis-drawn batches with duplicate
keys, and a subprocess runs the port's store with pyarrow, pandas and jax
made unimportable.
"""

import os
import subprocess
import sys
import tempfile
import threading

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from starrocks_tpu import types as JT
from starrocks_tpu.column import HostTable as JHostTable
from starrocks_tpu.exprs.ir import Call as JCall, Col as JCol, Lit as JLit
from starrocks_tpu.runtime.config import config as jcfg
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu.storage.store import TabletStore as JStore

from starrocks_tpu_torch import types as TT
from starrocks_tpu_torch.column import HostTable as THostTable
from starrocks_tpu_torch.exprs.ir import Call, Col, Lit
from starrocks_tpu_torch.runtime.config import config as tcfg
from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.storage.store import (
    TabletStore, backup, restore,
)

from torch_sql_scripts import (  # noqa: F401 (fixture)
    _default_knobs, run_both, sessions,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _restart(tmp_path):
    return (JSession(data_dir=str(tmp_path / "jax")),
            Session(device="cpu", data_dir=str(tmp_path / "port")))


def _set_both(name, value):
    jcfg.set(name, value)
    tcfg.set(name, value)


def _entries(index) -> dict:
    """The port's primary index as the reference's dict: {key tuple:
    (rowset, file, position)}."""
    names = index.keys.dtype.names
    return {tuple(r[nm].item() for nm in names): (int(a), int(b), int(c))
            for r, a, b, c in zip(index.keys, index.ri, index.fi, index.pos)}


def _manifests_equal(js, ts, tables):
    for t in tables:
        assert ts.store.read_manifest(t) == js.store.read_manifest(t), t


# --- round trips ---------------------------------------------------------------


def test_create_insert_restart_roundtrip(tmp_path):
    js, ts = sessions(tmp_path)
    script = [
        "create table t (a int not null, b varchar, c decimal(10,2)) "
        "distributed by hash(a) buckets 4",
        "insert into t values (1, 'x', 1.50), (2, 'y', 2.25), (3, 'x', 0.75)",
        "insert into t values (4, 'z', 9.99)",
        "select b, sum(c) sc from t group by b order by b",
    ]
    out = run_both(js, ts, script)
    assert out[-1][1] == [("x", 2.25), ("y", 2.25), ("z", 9.99)]
    js, ts = _restart(tmp_path)
    run_both(js, ts, [script[-1]])
    files = os.listdir(tmp_path / "port" / "t")
    assert (any(f.endswith(".parquet") for f in files)
            and "manifest.json" in files)
    _manifests_equal(js, ts, ["t"])
    run_both(js, ts, ["drop table t"])
    js, ts = _restart(tmp_path)
    run_both(js, ts, ["select * from t", "show tables"])


def test_nulls_and_strings_roundtrip(tmp_path):
    js, ts = sessions(tmp_path)
    run_both(js, ts, [
        "create table u (a int, b varchar, c date, d double, "
        "e decimal(30,2), f boolean) distributed by hash(a) buckets 2",
        "insert into u values (1, 'aa', date '2024-01-01', 1.5, 10.25, true),"
        " (null, 'bb', null, null, null, false), (3, null, "
        "date '2020-02-29', -2.5, -7.5, null), (4, '', null, 0.0, 0, null)",
        "insert into u select a + 10, b, c, d, e, f from u where a is not null",
    ])
    js, ts = _restart(tmp_path)
    run_both(js, ts, [
        "select a, b, c, d, e, f from u order by a nulls first",
        "select b, count(*) n from u group by b order by b",
        "select count(*) from u where b is null",
        "explain select b, count(*) from u group by b",
    ])
    _manifests_equal(js, ts, ["u"])


def test_insert_select_persisted(tmp_path):
    js, ts = sessions(tmp_path)
    run_both(js, ts, [
        "create table src (a int, b double)",
        "insert into src values (1, 1.5), (2, 2.5), (3, 3.5)",
        "create table dst (a int, b double)",
        "insert into dst select a, b * 2 from src where a >= 2",
    ])
    js, ts = _restart(tmp_path)
    out = run_both(js, ts, ["select sum(b) s from dst group by a > 0"])
    assert out[0][1] == [(12.0,)]


# --- zonemaps and partitions ------------------------------------------------------


def test_zonemap_pruning_stats_equal_reference(tmp_path):
    jstore, tstore = JStore(str(tmp_path / "j")), TabletStore(str(tmp_path / "t"))
    for store, HT in ((jstore, JHostTable), (tstore, THostTable)):
        h1 = HT.from_pydict({"k": np.arange(0, 100), "v": np.arange(100) * 1.0})
        h2 = HT.from_pydict({"k": np.arange(1000, 1100),
                             "v": np.arange(100) * 2.0})
        store.create_table("t", h1.schema, (), 1)
        store.insert("t", h1)
        store.insert("t", h2)
    for pred in [("gt", 500), ("eq", 50), ("gt", 10 ** 6), ("le", 99),
                 ("lt", 0), ("ge", 1099)]:
        jout = jstore.load_table("t", predicate=JCall(
            pred[0], JCol("t.k"), JLit(pred[1])))
        tout = tstore.load_table("t", predicate=Call(
            pred[0], Col("t.k"), Lit(pred[1])))
        assert tstore.last_scan_stats == jstore.last_scan_stats, pred
        assert tout.to_pylist() == jout.to_pylist(), pred
    assert tstore.scan_stats()["pruned"] == 1
    cols, stats = tstore.load_table("t", columns=["v"], with_stats=True)
    assert cols.num_rows == 200 and stats["files"] == 2


def test_range_partitions_pruning_and_show(tmp_path):
    js, ts = sessions(tmp_path)
    out = run_both(js, ts, [
        "CREATE TABLE events (id BIGINT, d DATE, v DOUBLE) "
        "PARTITION BY RANGE(d) ("
        " PARTITION p1 VALUES LESS THAN ('2024-01-01'),"
        " PARTITION p2 VALUES LESS THAN ('2024-07-01'),"
        " PARTITION p3 VALUES LESS THAN (MAXVALUE))",
        "INSERT INTO events VALUES "
        "(1, DATE '2023-05-01', 1.0), (2, DATE '2023-11-30', 2.0),"
        "(3, DATE '2024-02-01', 3.0), (4, DATE '2024-06-30', 4.0),"
        "(5, DATE '2024-12-25', 5.0)",
        "SHOW PARTITIONS FROM events",
    ])
    assert [p[4] for p in out[-1][1]] == [2, 2, 1]
    js, ts = _restart(tmp_path)
    run_both(js, ts, [
        "SELECT sum(v) FROM events WHERE d >= DATE '2024-08-01'",
        "SELECT count(*) FROM events WHERE d < DATE '2024-01-01'",
    ])
    import datetime

    days = (datetime.date(2024, 8, 1) - datetime.date(1970, 1, 1)).days
    jout = js.store.load_table("events", predicate=JCall(
        "ge", JCol("events.d"), JLit(days, JT.DATE)))
    tout = ts.store.load_table("events", predicate=Call(
        "ge", Col("events.d"), Lit(days, TT.DATE)))
    assert ts.store.last_scan_stats == js.store.last_scan_stats
    assert ts.store.last_scan_stats["partition_pruned"] >= 2
    assert tout.to_pylist() == jout.to_pylist()
    _manifests_equal(js, ts, ["events"])


def test_partition_bound_violation_and_datetime_partitions(tmp_path):
    js, ts = sessions(tmp_path)
    out = run_both(js, ts, [
        "CREATE TABLE b (x BIGINT) PARTITION BY RANGE(x) ("
        " PARTITION p1 VALUES LESS THAN (10))",
        "INSERT INTO b VALUES (11)",
        "INSERT INTO b VALUES (9)",
        "SELECT count(*) FROM b",
        "CREATE TABLE ev (ts DATETIME, v BIGINT) PARTITION BY RANGE(ts) ("
        " PARTITION h1 VALUES LESS THAN ('2024-01-01 12:00:00'),"
        " PARTITION h2 VALUES LESS THAN (MAXVALUE))",
        "INSERT INTO ev VALUES ('2024-01-01 08:00:00', 1),"
        "('2024-01-01 18:30:00', 2)",
        "SHOW PARTITIONS FROM ev",
        "SELECT sum(v) FROM ev",
        "CREATE TABLE pd (x BIGINT, v BIGINT) PARTITION BY RANGE(x) ("
        " PARTITION lo VALUES LESS THAN (100),"
        " PARTITION hi VALUES LESS THAN (MAXVALUE))",
        "INSERT INTO pd VALUES (1, 10), (50, 20), (150, 30)",
        "DELETE FROM pd WHERE x = 50",
        "SHOW PARTITIONS FROM pd",
        "SELECT sum(v) FROM pd",
    ])
    assert out[1] == ("error", "ValueError")
    with pytest.raises(ValueError, match="partition bound"):
        ts.sql("INSERT INTO b VALUES (12)")
    assert [p[4] for p in out[6][1]] == [1, 1]
    assert [p[4] for p in out[11][1]] == [1, 1]
    _manifests_equal(js, ts, ["b", "ev", "pd"])


# --- primary keys ------------------------------------------------------------------


def test_pk_upsert_delta_path(tmp_path):
    _set_both("compaction_trigger_rowsets", 0)  # isolate the delta path
    js, ts = sessions(tmp_path)
    n = 5000
    rows = ", ".join(f"({i}, 'v{i}')" for i in range(n))
    up = ", ".join(f"({i}, 'NEW{i}')" for i in range(0, n, 100))
    run_both(js, ts, [
        "CREATE TABLE kv (k BIGINT, v VARCHAR, PRIMARY KEY(k)) "
        "DISTRIBUTED BY HASH(k) BUCKETS 3",
        f"INSERT INTO kv VALUES {rows}",
        f"INSERT INTO kv VALUES {up}",
    ])
    m = ts.store.read_manifest("kv")
    assert len(m["rowsets"]) == 2  # base + delta, no rewrite
    base_bytes = sum(os.path.getsize(tmp_path / "port" / "kv" / f["file"])
                     for f in m["rowsets"][0]["files"])
    delta_bytes = sum(os.path.getsize(tmp_path / "port" / "kv" / f["file"])
                      for f in m["rowsets"][1]["files"])
    assert delta_bytes < base_bytes / 10, (delta_bytes, base_bytes)
    assert sum(len(f.get("delvec") or ())
               for f in m["rowsets"][0]["files"]) == 50
    _manifests_equal(js, ts, ["kv"])
    run_both(js, ts, [
        "SELECT count(*) FROM kv",
        "SELECT v FROM kv WHERE k = 200",
        "SELECT v FROM kv WHERE k = 201",
        # a second upsert hits the DELTA rowset's rows too
        "INSERT INTO kv VALUES (200, 'NEWER200'), (200, 'NEWEST200')",
        "SELECT v FROM kv WHERE k = 200",
        "SELECT count(*) FROM kv",
        "INSERT INTO kv VALUES (null, 'x')",
    ])
    _manifests_equal(js, ts, ["kv"])
    index = _entries(ts.store._pk_index["kv"])
    # restart: delvecs replay from the manifest; the index rebuilt from the
    # files equals the one the upserts maintained
    js, ts = _restart(tmp_path)
    run_both(js, ts, ["SELECT v FROM kv WHERE k = 200",
                      "SELECT count(*) FROM kv"])
    m = ts.store.read_manifest("kv")
    keys = [k for ks in m["unique_keys"] for k in ks]
    assert _entries(ts.store._load_pk_index("kv", m, keys)) == index
    # compaction materializes the delvecs and resets the file count
    assert ts.store.compact_table("kv") == js.store.compact_table("kv") == n
    m2 = ts.store.read_manifest("kv")
    assert len(m2["rowsets"]) == 1
    assert not any(f.get("delvec") for f in m2["rowsets"][0]["files"])
    _manifests_equal(js, ts, ["kv"])
    js.cache.invalidate("kv")
    js.catalog.get_table("kv").invalidate()
    ts.catalog.get_table("kv").invalidate()
    out = run_both(js, ts, ["SELECT v FROM kv WHERE k = 200",
                            "SELECT count(*) FROM kv",
                            "SELECT k, v FROM kv ORDER BY k LIMIT 5"])
    assert out[0][1] == [("NEWEST200",)] and out[1][1] == [(n,)]


def test_pk_upsert_varchar_and_date_keys(tmp_path):
    js, ts = sessions(tmp_path)
    run_both(js, ts, [
        "CREATE TABLE sv (k VARCHAR, d DATE, v BIGINT, PRIMARY KEY(k, d))",
        "INSERT INTO sv VALUES ('a', DATE '2024-01-01', 1),"
        "('b', DATE '2024-01-01', 2)",
        # fresh batch: a new dictionary where 'b' has a different code
        "INSERT INTO sv VALUES ('b', DATE '2024-01-01', 30)",
        "SELECT k, v FROM sv ORDER BY k",
    ])
    js, ts = _restart(tmp_path)
    out = run_both(js, ts, [
        "INSERT INTO sv VALUES ('a', DATE '2024-01-01', 100),"
        "('c', DATE '2024-02-02', 3), ('a', DATE '2024-01-02', 4)",
        "SELECT k, d, v FROM sv ORDER BY k, d",
    ])
    assert out[-1][1] == [("a", "2024-01-01", 100), ("a", "2024-01-02", 4),
                          ("b", "2024-01-01", 30), ("c", "2024-02-02", 3)]
    _manifests_equal(js, ts, ["sv"])


def test_compaction_bounds_file_count(tmp_path):
    js, ts = sessions(tmp_path)
    script = ["CREATE TABLE t (k BIGINT, v DOUBLE)"] + [
        f"INSERT INTO t VALUES ({i}, {i * 1.5})" for i in range(20)]
    run_both(js, ts, script + ["SELECT count(*) c, sum(v) sv FROM t"])
    files = [f for f in os.listdir(tmp_path / "port" / "t")
             if f.endswith(".parquet")]
    assert len(files) < tcfg.get("compaction_trigger_rowsets") + 1, files
    _manifests_equal(js, ts, ["t"])
    out = run_both(js, ts, [
        "SELECT * FROM information_schema.compactions",
        "SELECT count(*) FROM information_schema.loads"])
    assert len(out[0][1]) == 2


# --- schema change -------------------------------------------------------------------


def test_alter_add_drop_readd(tmp_path):
    js, ts = sessions(tmp_path)
    run_both(js, ts, [
        "CREATE TABLE t (a BIGINT, b VARCHAR)",
        "INSERT INTO t VALUES (1, 'x'), (2, 'y')",
        "ALTER TABLE t ADD COLUMN c DOUBLE",
        "SELECT a, c FROM t ORDER BY a",
        "INSERT INTO t VALUES (3, 'z', 1.5)",
        "SELECT a, c FROM t ORDER BY a",
        "SELECT sum(c) FROM t",
        "ALTER TABLE t DROP COLUMN b",
        "DESCRIBE t",
        "ALTER TABLE t ADD COLUMN b DOUBLE",
        "SELECT a, b, c FROM t ORDER BY a",
        "INSERT INTO t VALUES (4, 2.0, 4.5)",
        "SELECT sum(b), count(b) FROM t",
        "ALTER TABLE t DROP COLUMN nothing",
        "ALTER TABLE t ADD COLUMN req BIGINT NOT NULL",
        "DESCRIBE t",
    ])
    _manifests_equal(js, ts, ["t"])
    js, ts = _restart(tmp_path)
    run_both(js, ts, ["SELECT a, b, c FROM t ORDER BY a", "SELECT b FROM t"
                      " WHERE a = 1", "SELECT nothing FROM t"])
    # compaction reads every file by its live columns: the dropped bytes
    # of the old `b` stay dropped
    ts.store.compact_table("t")
    ts.catalog.get_table("t").invalidate()
    ts.cache.invalidate("t")
    assert ts.sql("SELECT a, b, c FROM t ORDER BY a").rows() == [
        (1, None, None), (2, None, None), (3, None, 1.5), (4, 4.5, 2.0)]


def test_alter_in_memory_and_guards():
    js, ts = sessions()
    run_both(js, ts, [
        "CREATE TABLE m (k BIGINT, v BIGINT, PRIMARY KEY(k))",
        "INSERT INTO m VALUES (1, 10)",
        "ALTER TABLE m ADD COLUMN note VARCHAR",
        "SELECT k, note FROM m",
        "ALTER TABLE m DROP COLUMN k",
        "ALTER TABLE m ADD COLUMN req BIGINT NOT NULL",
        "ALTER TABLE nope ADD COLUMN x BIGINT",
        "ALTER TABLE m ADD COLUMN arr ARRAY<BIGINT>",
        "SELECT k, note, arr FROM m",
        "ALTER TABLE m ADD COLUMN arr BIGINT",
    ])


# --- journal, image, backup ---------------------------------------------------------


def test_image_checkpoint_and_editlog_compaction(tmp_path):
    d = str(tmp_path / "db")
    s = Session(device="cpu", data_dir=d)
    s.sql("create table base (g varchar, v int)")
    s.sql("insert into base values ('a', 1), ('a', 2), ('b', 5)")
    for i in range(300):
        s.sql(f"create view churn_{i} as select g from base")
        s.sql(f"drop table churn_{i}")
    s.sql("create view keepv as select g, sum(v) sv from base group by g")
    s.sql("create materialized view keepmv as "
          "select g, count(*) c from base group by g")
    assert os.path.exists(s.store.image_path)
    n_tail = sum(1 for _ in open(s.store.log_path))
    assert n_tail <= Session.CHECKPOINT_OPS + 8, n_tail
    s2 = Session(device="cpu", data_dir=d)
    assert s2.sql("select g, sv from keepv order by g").rows() == [
        ("a", 3), ("b", 5)]
    assert s2.sql("select g, c from keepmv order by g").rows() == [
        ("a", 2), ("b", 1)]
    assert "churn_7" not in s2.catalog.views
    s2.sql("create view lastv as select v from base")
    s2.checkpoint_metadata()
    assert sum(1 for _ in open(s2.store.log_path)) == 0
    s3 = Session(device="cpu", data_dir=d)
    assert "lastv" in s3.catalog.views
    assert s3.sql("select count(*) from keepmv").rows() == [(2,)]


def test_checkpoint_concurrent_log_no_lost_ops(tmp_path):
    store = TabletStore(str(tmp_path / "db"))
    store.log({"op": "seed"})
    stop = threading.Event()
    logged = []

    def writer():
        i = 0
        while not stop.is_set():
            logged.append(store.log({"op": "w", "i": i}))
            i += 1

    t = threading.Thread(target=writer)
    t.start()
    try:
        for _ in range(60):
            store.checkpoint({"tables": {}})
    finally:
        stop.set()
        t.join()
    img = store.read_image()
    tail_seqs = {op["seq"] for op in store.replay(after_seq=img["seq"])}
    lost = [s for s in logged if s > img["seq"] and s not in tail_seqs]
    assert lost == [], f"ops lost by checkpoint/log race: {lost}"


def test_backup_restore(tmp_path):
    d1, d2, d3 = (str(tmp_path / "db"), str(tmp_path / "bk"),
                  str(tmp_path / "rs"))
    s = Session(device="cpu", data_dir=d1)
    s.sql("create table t (a int, b varchar, primary key(a))")
    s.sql("insert into t values (1, 'x'), (2, 'y')")
    assert backup(s.store, d2) == 1
    s.sql("insert into t values (3, 'z')")  # after the snapshot
    assert restore(d2, d3) == 1
    s2 = Session(device="cpu", data_dir=d3)
    assert s2.sql("select a, b from t order by a").rows() == [
        (1, "x"), (2, "y")]
    s2.sql("insert into t values (1, 'X')")  # PK semantics survive
    assert s2.sql("select a, b from t order by a").rows() == [
        (1, "X"), (2, "y")]
    with pytest.raises(ValueError):
        restore(d2, d3)
    with pytest.raises(ValueError):
        backup(s.store, d2)


def test_point_plane_raises(tmp_path):
    """The point plane is ported (slice 8): `point_lookup` and
    `delete_rows` over a stored PRIMARY KEY table, after an upsert, answer
    as the reference's store does (rows in storage order, duplicates and
    missing keys collapsed)."""
    script = ["create table t (k bigint, s varchar, v double, "
              "primary key(k)) distributed by hash(k) buckets 4",
              "insert into t values (1, 'a', 1.5), (2, 'b', 2.5), "
              "(3, 'c', 3.5), (4, 'd', 4.5)",
              "insert into t values (2, 'B', 20.5)"]
    js = JSession(data_dir=str(tmp_path / "j"))
    ts = Session(device="cpu", data_dir=str(tmp_path / "t"))
    for st in script:
        js.sql(st)
        ts.sql(st)
    keys = [(2,), (4,), (9,), (2,)]
    for cols in (None, ["s"]):
        assert ts.store.point_lookup("t", keys, columns=cols).to_pylist() \
            == js.store.point_lookup("t", keys, columns=cols).to_pylist()
    assert ts.store.delete_rows("t", [(1,), (9,)]) == \
        js.store.delete_rows("t", [(1,), (9,)]) == 1
    assert ts.store.point_lookup("t", [(1,)]).num_rows == 0
    for sess in (js, ts):
        sess.store.read_manifest("t")
    assert TabletStore(str(tmp_path / "t")).point_lookup(
        "t", [(3,), (2,)]).to_pylist() == JStore(str(tmp_path / "j")) \
        .point_lookup("t", [(3,), (2,)]).to_pylist()


# --- the vectorised primary index -------------------------------------------------------


_batch = st.lists(
    st.tuples(st.integers(-3, 6), st.sampled_from(["", "a", "b", "zz", "é"]),
              st.integers(-1000, 1000)),
    min_size=1, max_size=40)


@settings(max_examples=25, deadline=None)
@given(batches=st.lists(_batch, min_size=1, max_size=4),
       buckets=st.integers(1, 4))
def test_pk_index_equals_dict_index(batches, buckets):
    """Upserts of batches with duplicate keys through both stores: the
    port's vectorised index equals the reference's dict index entry for
    entry, the manifests (delete vectors included) are equal, and the
    index rebuilt from the files after a restart is the same."""
    old = (jcfg.get("compaction_trigger_rowsets"),
           tcfg.get("compaction_trigger_rowsets"))
    _set_both("compaction_trigger_rowsets", 0)
    try:
        with tempfile.TemporaryDirectory() as d:
            stores = (JStore(os.path.join(d, "j")),
                      TabletStore(os.path.join(d, "t")))
            for store, HT, TY in ((stores[0], JHostTable, JT),
                                  (stores[1], THostTable, TT)):
                types = {"k": TY.BIGINT, "s": TY.VARCHAR, "v": TY.BIGINT}
                for i, b in enumerate(batches):
                    ht = HT.from_pydict(
                        {"k": [r[0] for r in b], "s": [r[1] for r in b],
                         "v": [r[2] for r in b]}, types=types)
                    if i == 0:
                        store.create_table("p", ht.schema, ("k",), buckets,
                                           unique_keys=[("k", "s")])
                    store.upsert("p", ht)
            jstore, tstore = stores
            want = jstore._pk_index["p"]
            assert _entries(tstore._pk_index["p"]) == want
            assert tstore.read_manifest("p") == jstore.read_manifest("p")
            fresh = TabletStore(os.path.join(d, "t"))
            m = fresh.read_manifest("p")
            assert _entries(fresh._load_pk_index("p", m, ["k", "s"])) == want
            got = fresh.load_table("p").to_pylist()
            assert got == jstore.load_table("p").to_pylist()
            assert len(got) == len(want)
    finally:
        jcfg.set("compaction_trigger_rowsets", old[0])
        tcfg.set("compaction_trigger_rowsets", old[1])


def test_null_primary_key_raises_in_the_store(tmp_path):
    store = TabletStore(str(tmp_path))
    ht = THostTable.from_pydict({"k": [1, None], "v": [1, 2]},
                                types={"k": TT.BIGINT, "v": TT.BIGINT})
    store.create_table("t", ht.schema, (), 1, unique_keys=[("k",)])
    with pytest.raises(ValueError, match="NULL value in PRIMARY KEY"):
        store.upsert("t", ht)


# --- no pyarrow ------------------------------------------------------------------------


_NO_ARROW = r"""
import sys, tempfile
for mod in ("pyarrow", "pyarrow.parquet", "pandas", "jax"):
    sys.modules[mod] = None
from starrocks_tpu_torch.runtime.session import Session
from starrocks_tpu_torch.storage.store import backup, restore
d = tempfile.mkdtemp()
s = Session(device="cpu", data_dir=d + "/db")
s.sql("create table t (k bigint, s varchar, x decimal(12,2), "
      "primary key(k)) distributed by hash(k) buckets 4")
s.sql("insert into t values (1, 'a', 1.5), (2, null, 2.5), (3, 'c', null)")
s.sql("insert into t values (2, 'b', 9.0)")
s.sql("create table u as select s, sum(x) sx from t group by s")
s.sql("delete from t where k = 3")
s.store.compact_table("t")
backup(s.store, d + "/bk")
restore(d + "/bk", d + "/rs")
s2 = Session(device="cpu", data_dir=d + "/rs")
assert s2.sql("select k, s, x from t order by k").rows() == [
    (1, "a", 1.5), (2, "b", 9.0)], s2.sql("select * from t").rows()
assert "pyarrow" not in {m.split(".")[0] for m, v in sys.modules.items()
                         if v is not None}
print("ok")
"""


def test_store_runs_without_pyarrow():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _NO_ARROW], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]
