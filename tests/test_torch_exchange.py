"""The port's mesh and exchanges (starrocks_tpu_torch/parallel/) against the
JAX package's, shard for shard.

The same seeded numpy table goes through the JAX package's collectives
inside shard_map over the 8 virtual CPU devices (tests/conftest.py) and
through the port's over an in-process 8-shard mesh; every shard's output
must be EXACTLY equal: data, validity, selection and the overflow counts.
Also the port's counterparts of tests/test_parallel.py (against pandas, as
there) and the runtime filters' cross-shard merge (ops/join.py) against the
JAX package's `axis` versions."""

import decimal

import numpy as np
import pandas as pd
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from starrocks_tpu import types as JT
from starrocks_tpu.column import HostTable as JHostTable
from starrocks_tpu.exprs import AggExpr as JAgg, col as jcol
from starrocks_tpu.ops.join import (
    bloom_filter_mask as j_bloom_mask, runtime_filter_mask as j_rf_mask,
)
from starrocks_tpu.parallel import (
    BROADCAST as J_BROADCAST, broadcast_join as j_broadcast_join,
    chunk_pspec, dist_aggregate as j_dist_aggregate, make_mesh as j_make_mesh,
    shard_host_table as j_shard_host_table,
)
from starrocks_tpu.parallel.exchange import (
    all_gather_chunk as j_all_gather, range_partition_chunk as j_range,
    shuffle_chunk as j_shuffle,
)
from starrocks_tpu.parallel.mesh import shard_map

from starrocks_tpu_torch import types as TT
from starrocks_tpu_torch.column import HostTable as THostTable
from starrocks_tpu_torch.exprs.ir import AggExpr as TAgg, Col as TCol
from starrocks_tpu_torch.ops.join import (
    bloom_filter_mask, pack_keys, runtime_filter_mask,
)
from starrocks_tpu_torch.parallel import (
    BROADCAST, SHUFFLE, Mesh, all_gather_chunk, broadcast_join,
    dist_aggregate, make_mesh, range_partition_chunk, shard_host_table, shuffle_chunk,
)

N = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs in six processes on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jmesh(eight_devices):
    return j_make_mesh(N)


@pytest.fixture()
def tmesh():
    return Mesh(N, "cpu")


def _data(n, seed, nulls=True, wide=True):
    """{name: values} and the two packages' types: an int key with NULLs, a
    float, a string (dictionary) and a DECIMAL(38) (a [cap, 4] column)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 37, n).astype(object)
    if nulls:
        k[rng.random(n) < 0.1] = None
    words = ["amber", "brick", "coral", "dune", "ember"]
    d = {"k": list(k), "v": rng.normal(size=n).tolist(),
         "s": [words[i] for i in rng.integers(0, 5, n)]}
    jt, tt = {"k": JT.BIGINT}, {"k": TT.BIGINT}
    if wide:
        d["w"] = [decimal.Decimal(int(x)).scaleb(-2) * (10 ** 20)
                  for x in rng.integers(-10 ** 6, 10 ** 6, n)]
        jt["w"], tt["w"] = JT.DECIMAL(38, 2), TT.DECIMAL(38, 2)
    return d, jt, tt


def _tables(n, seed, **kw):
    d, jt, tt = _data(n, seed, **kw)
    return JHostTable.from_pydict(d, types=jt), THostTable.from_pydict(d, types=tt)


def _jax_shards(x):
    """One global (row-sharded) array -> its 8 shards as numpy."""
    return np.split(np.asarray(x), N)


def _assert_chunk_shards_equal(jchunk, tchunks):
    """Every shard of a JAX shard_map output Chunk equals the port's."""
    assert len(tchunks) == N
    for i, name in enumerate(jchunk.schema.names):
        js = _jax_shards(jchunk.data[i])
        for s in range(N):
            np.testing.assert_array_equal(js[s], tchunks[s].data[i].numpy(),
                                          err_msg=f"{name} shard {s}")
        jv = jchunk.valid[i]
        if jv is None:
            assert all(c.valid[i] is None for c in tchunks), name
        else:
            for s, v in enumerate(_jax_shards(jv)):
                np.testing.assert_array_equal(v, tchunks[s].valid[i].numpy())
    for s, v in enumerate(_jax_shards(jchunk.sel_mask())):
        np.testing.assert_array_equal(v, tchunks[s].sel_mask().numpy(),
                                      err_msg=f"sel shard {s}")


def _jrun(jmesh, g, fn, n_out):
    """fn(local) -> tuple of n_out row-sharded outputs, inside shard_map."""
    return jax.jit(shard_map(
        fn, mesh=jmesh, in_specs=(chunk_pspec(g),),
        out_specs=tuple(P("d") for _ in range(n_out)), check_vma=False))(g)


# --- placement ----------------------------------------------------------------


def test_mesh_needs_its_device_named():
    """No mesh lands on the CPU unless the caller asks for it."""
    with pytest.raises(TypeError):
        make_mesh(8)
    with pytest.raises(TypeError):
        Mesh(8)
    assert make_mesh(8, device="cpu").device == torch.device("cpu")


def test_shard_host_table_matches_jax(jmesh, tmesh):
    jt, tt = _tables(4000, 0)
    g = j_shard_host_table(jt, jmesh)
    t = shard_host_table(tt, tmesh)
    assert all(c.capacity % 8 == 0 for c in t)
    assert sum(int(c.num_rows()) for c in t) == 4000
    _assert_chunk_shards_equal(g, t)


# --- hash shuffle ---------------------------------------------------------------


@pytest.mark.parametrize("keys,cap", [
    (("k",), 512),          # NULL keys hash like a value
    (("k", "s"), 512),      # two keys, one a dictionary's codes
    (("k",), 64),           # buckets overflow: rows drop, count reported
])
def test_shuffle_matches_jax_shard_for_shard(jmesh, tmesh, keys, cap):
    jt, tt = _tables(3000, 1)
    g = j_shard_host_table(jt, jmesh)
    t = shard_host_table(tt, tmesh)
    jout, jmx = _jrun(jmesh, g, lambda c: (lambda o, m: (o, m[None]))(
        *j_shuffle(c, tuple(jcol(k) for k in keys), "d", N, cap)), 2)
    tout, tmx = shuffle_chunk(t, tuple(TCol(k) for k in keys), tmesh, cap)
    _assert_chunk_shards_equal(jout, tout)
    assert [int(x) for x in np.asarray(jmx)] == [int(x) for x in tmx]
    if cap == 64:
        assert max(int(x) for x in tmx) > cap  # the overflow case
    assert tmesh.moves == {"all_to_all": [N * cap]}


def test_shuffle_exact_full_bucket_no_collision(jmesh, tmesh):
    """tests/test_parallel.py's regression: dead padding rows must not
    clobber slots of an exactly-full bucket."""
    d = {"k": [7] * 48, "v": list(range(48))}
    g = j_shard_host_table(JHostTable.from_pydict(d), jmesh)
    t = shard_host_table(THostTable.from_pydict(d), tmesh)
    jout, jmx = _jrun(jmesh, g, lambda c: (lambda o, m: (o, m[None]))(
        *j_shuffle(c, (jcol("k"),), "d", N, 64)), 2)
    tout, tmx = shuffle_chunk(t, (TCol("k"),), tmesh, 64)
    _assert_chunk_shards_equal(jout, tout)
    assert sum(int(c.num_rows()) for c in tout) == 48  # no rows lost
    vs = sorted(int(c.data[1][i]) for c in tout
                for i in torch.nonzero(c.sel_mask()).flatten().tolist())
    assert vs == list(range(48))
    assert [int(x) for x in np.asarray(jmx)] == [int(x) for x in tmx]


# --- range exchange and gather -----------------------------------------------


@pytest.mark.parametrize("column", ["v", "k"])
def test_range_partition_matches_jax(jmesh, tmesh, column):
    jt, tt = _tables(3000, 2, wide=False)
    g = j_shard_host_table(jt, jmesh)
    t = shard_host_table(tt, tmesh)

    def jfn(c):
        i = c.schema.index(column)
        rank = c.data[i]
        if c.valid[i] is not None:
            rank = jax.numpy.where(c.valid[i], rank,
                                   jax.numpy.iinfo(rank.dtype).max)
        o, m = j_range(c, rank, "d", N, 1024)
        return o, m[None]

    def trank(c):
        i = c.schema.index(column)
        rank = c.data[i]
        if c.valid[i] is not None:
            rank = torch.where(c.valid[i], rank, torch.iinfo(rank.dtype).max)
        return rank

    jout, jmx = _jrun(jmesh, g, jfn, 2)
    tout, tmx = range_partition_chunk(t, [trank(c) for c in t], tmesh, 1024)
    _assert_chunk_shards_equal(jout, tout)
    assert [int(x) for x in np.asarray(jmx)] == [int(x) for x in tmx]


def test_all_gather_matches_jax(jmesh, tmesh):
    jt, tt = _tables(2500, 3)
    g = j_shard_host_table(jt, jmesh)
    t = shard_host_table(tt, tmesh)
    (jout,) = _jrun(jmesh, g, lambda c: (j_all_gather(c, "d"),), 1)
    tout = all_gather_chunk(t, tmesh)
    # every JAX shard holds the same gathered chunk; the port holds it once
    _assert_chunk_shards_equal(jout, (tout,) * N)
    assert tmesh.moves == {"all_gather": [t[0].capacity]}


# --- distributed operators ------------------------------------------------------


def _agg_specs(pkg):
    A, c = (JAgg, jcol) if pkg == "jax" else (TAgg, TCol)
    return ((("k", c("k")),),
            (("s", A("sum", c("v"))), ("c", A("count", None)),
             ("a", A("avg", c("v")))))


@pytest.mark.parametrize("via", [BROADCAST, SHUFFLE])
def test_dist_aggregate_matches_jax_and_pandas(jmesh, tmesh, via):
    jt, tt = _tables(4000, 4, nulls=False, wide=False)
    g = j_shard_host_table(jt, jmesh)
    t = shard_host_table(tt, tmesh)
    jgb, jaggs = _agg_specs("jax")

    def jfn(local):
        out, ng, mb, png = j_dist_aggregate(
            local, group_by=jgb, aggs=jaggs, axis="d", n_shards=N,
            partial_groups=64, final_groups=64, via=via, bucket_capacity=64)
        return out, ng[None], mb[None], png[None]

    jout, jng, jmb, jpng = _jrun(jmesh, g, jfn, 4)
    tgb, taggs = _agg_specs("torch")
    out, ng, mb, png = dist_aggregate(t, tgb, taggs, tmesh, 64, 64, via=via,
                                      bucket_capacity=64)
    assert [int(x) for x in np.asarray(jpng)] == [int(x) for x in png]
    assert [int(x) for x in np.asarray(jmb)] == [int(x) for x in mb]
    if via == J_BROADCAST:
        out, ng = (out,) * N, (ng,) * N
    _assert_chunk_shards_equal(jout, out)
    assert [int(x) for x in np.asarray(jng)] == [int(x) for x in ng]
    # tests/test_parallel.py's pandas oracle
    ngroups = int(ng[0]) if via == BROADCAST else sum(int(x) for x in ng)
    rows = [r for c in (out[:1] if via == BROADCAST else out)
            for r in THostTable.from_chunk(c).to_pylist()]
    got = pd.DataFrame(rows, columns=["k", "s", "c", "a"]).sort_values(
        "k").reset_index(drop=True)
    df = pd.DataFrame({"k": tt.arrays["k"], "v": tt.arrays["v"]})
    exp = df.groupby("k", as_index=False).agg(
        s=("v", "sum"), c=("v", "size"), a=("v", "mean")
    ).sort_values("k").reset_index(drop=True)
    assert ngroups == len(exp)
    np.testing.assert_array_equal(got["k"], exp["k"])
    np.testing.assert_allclose(got["s"], exp["s"], rtol=1e-9)
    np.testing.assert_array_equal(got["c"], exp["c"])
    np.testing.assert_allclose(got["a"], exp["a"], rtol=1e-9)


def test_broadcast_join_matches_jax_and_pandas(jmesh, tmesh):
    rng = np.random.default_rng(5)
    fact = {"fk": rng.integers(1, 51, 3000), "fv": np.arange(3000)}
    dim = {"dk": np.arange(1, 51), "dv": rng.normal(size=50)}
    gf = j_shard_host_table(JHostTable.from_pydict(fact), jmesh)
    gd = j_shard_host_table(JHostTable.from_pydict(dim), jmesh)
    tf = shard_host_table(THostTable.from_pydict(fact), tmesh)
    td = shard_host_table(THostTable.from_pydict(dim), tmesh)
    jout, jn = jax.jit(shard_map(
        lambda f, d: (lambda o, b: (o, b[None]))(*j_broadcast_join(
            f, d, (jcol("fk"),), (jcol("dk"),), axis="d", payload=["dv"])),
        mesh=jmesh, in_specs=(chunk_pspec(gf), chunk_pspec(gd)),
        out_specs=(P("d"), P("d")), check_vma=False))(gf, gd)
    tout, tn = broadcast_join(tf, td, (TCol("fk"),), (TCol("dk"),), tmesh,
                              payload=["dv"])
    _assert_chunk_shards_equal(jout, tout)
    assert {int(x) for x in np.asarray(jn)} == {int(tn)}
    got = pd.DataFrame([r for c in tout
                        for r in THostTable.from_chunk(c).to_pylist()],
                       columns=["fk", "fv", "dv"]).sort_values(
        "fv").reset_index(drop=True)
    exp = pd.DataFrame(fact).merge(pd.DataFrame(dim), left_on="fk",
                                   right_on="dk")[["fk", "fv", "dv"]]
    exp = exp.sort_values("fv").reset_index(drop=True)
    np.testing.assert_array_equal(got["fk"], exp["fk"])
    np.testing.assert_allclose(got["dv"], exp["dv"], rtol=1e-12)


# --- runtime filters: the cross-shard merge (ops/join.py) ----------------------


def _rf_tables(seed):
    rng = np.random.default_rng(seed)
    probe = {"p": rng.integers(0, 400, 2000)}
    bk = rng.integers(100, 300, 900).astype(object)
    bk[rng.random(900) < 0.05] = None
    build = {"b": list(bk)}
    return probe, build


@pytest.mark.parametrize("kind", ["minmax", "dense", "bloom"])
@pytest.mark.parametrize("probe_sharded", [True, False])
def test_runtime_filters_merge_across_shards(jmesh, tmesh, kind,
                                             probe_sharded):
    probe, build = _rf_tables(6)
    jp = j_shard_host_table(JHostTable.from_pydict(probe), jmesh)
    jb = j_shard_host_table(JHostTable.from_pydict(build), jmesh)
    tp = shard_host_table(THostTable.from_pydict(probe), tmesh)
    tb = shard_host_table(THostTable.from_pydict(build), tmesh)
    kw = {"dense": {"dense_range": (0, 511)}, "bloom": {"bits": 1 << 12},
          "minmax": {}}[kind]
    jfn = j_bloom_mask if kind == "bloom" else j_rf_mask
    tfn = bloom_filter_mask if kind == "bloom" else runtime_filter_mask
    (jm,) = jax.jit(shard_map(
        lambda a, b: (jfn(a, b, (jcol("p"),), (jcol("b"),), None, "d",
                          **kw),),
        mesh=jmesh, in_specs=(chunk_pspec(jp), chunk_pspec(jb)),
        out_specs=(P("d"),), check_vma=False))(jp, jb)
    jm = _jax_shards(jm)
    if probe_sharded:
        tm = tfn(tp, tb, (TCol("p"),), (TCol("b"),), None, tmesh, **kw)
        for s in range(N):
            np.testing.assert_array_equal(jm[s], tm[s].numpy())
    else:
        # a REPLICATED probe against the sharded build: each JAX shard's
        # probe shard is a slice of the one replicated chunk
        whole = THostTable.from_pydict(probe).to_chunk(
            capacity=N * tp[0].capacity, device="cpu")
        tm = tfn(whole, tb, (TCol("p"),), (TCol("b"),), None, tmesh, **kw)
        np.testing.assert_array_equal(np.concatenate(jm), tm.numpy())
    # single-shard: the port's filter over the whole tables equals the JAX
    # package's, and the merged one keeps the same probe rows
    whole_b = THostTable.from_pydict(build).to_chunk(device="cpu")
    whole_p = THostTable.from_pydict(probe).to_chunk(device="cpu")
    single = tfn(whole_p, whole_b, (TCol("p"),), (TCol("b"),), None, **kw)
    jsingle = jfn(JHostTable.from_pydict(probe).to_chunk(),
                  JHostTable.from_pydict(build).to_chunk(),
                  (jcol("p"),), (jcol("b"),), None, **kw)
    np.testing.assert_array_equal(np.asarray(jsingle), single.numpy())
    keys, ok = pack_keys(whole_p, (TCol("p"),))
    got = np.concatenate([m.numpy() for m in (tm if probe_sharded else (tm,))])
    got_rows = sorted(int(k) for c, m in zip(
        tp if probe_sharded else (whole,), tm if probe_sharded else (tm,))
        for k in c.data[0][m & c.sel_mask()].tolist())
    want_rows = sorted(int(k) for k in keys[single & ok].tolist())
    assert got_rows == want_rows
    assert got.dtype == np.bool_
