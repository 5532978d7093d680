"""Star Schema Benchmark data generator (numpy, vectorized).

Reference behavior: the SSB kit the reference benchmarks with
(docs/en/benchmarking/SSB_Benchmarking.md — 13 queries over lineorder x
date/customer/supplier/part, plus the denormalized `lineorder_flat` used for
the headline SSB-flat numbers). Distributions simplified, schema faithful.

A copy of the JAX package's generator with only its imports changed: the
same sf and seed give bit-identical tables.

Scale factor SF: lineorder ≈ 6M·SF rows, customer 30k·SF, supplier 2k·SF,
part 200k·(1+log2 SF)-ish (here: 200k·SF min 1000), date = 7 years.
"""

from __future__ import annotations

import datetime

import numpy as np

from ... import types as T
from ...column import HostTable, StringDict

_EPOCH = datetime.date(1970, 1, 1)
DEC = T.DECIMAL(15, 2)

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
MFGRS = [f"MFGR#{i}" for i in range(1, 6)]


def _dates():
    start = datetime.date(1992, 1, 1)
    days = (datetime.date(1998, 12, 31) - start).days + 1
    d = np.arange(days)
    dates = np.array([start + datetime.timedelta(days=int(i)) for i in d])
    key = np.array([x.year * 10000 + x.month * 100 + x.day for x in dates], dtype=np.int32)
    year = np.array([x.year for x in dates], dtype=np.int32)
    month = np.array([x.month for x in dates], dtype=np.int32)
    weeknum = np.array([x.isocalendar()[1] for x in dates], dtype=np.int32)
    yearmonthnum = year * 100 + month
    yearmonth = [f"{x.strftime('%b')}{x.year}" for x in dates]
    return d, dates, key, year, month, weeknum, yearmonthnum, yearmonth


def gen_ssb(sf: float = 0.01, seed: int = 7) -> dict:
    rng = np.random.default_rng(seed)
    out = {}

    d_idx, d_dates, d_key, d_year, d_month, d_week, d_ymn, d_ym = _dates()
    nd = len(d_key)
    out["dates"] = HostTable.from_pydict(
        {
            "d_datekey": d_key,
            "d_date": [x.isoformat() for x in d_dates],
            "d_dayofweek": [x.strftime("%A") for x in d_dates],
            "d_month": [x.strftime("%B") for x in d_dates],
            "d_year": d_year,
            "d_yearmonthnum": d_ymn.astype(np.int32),
            "d_yearmonth": d_ym,
            "d_weeknuminyear": d_week,
        },
        types={"d_datekey": T.INT, "d_year": T.INT,
               "d_yearmonthnum": T.INT, "d_weeknuminyear": T.INT},
    )

    nc = max(int(30_000 * sf), 30)
    c_key = np.arange(1, nc + 1, dtype=np.int64)
    c_nation_i = rng.integers(0, 25, nc)
    nations = [
        "ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
        "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ", "JAPAN",
        "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU", "CHINA",
        "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA", "UNITED KINGDOM",
        "UNITED STATES",
    ]
    nation_region = [0, 1, 1, 1, 0, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2,
                     3, 4, 2, 3, 3, 1]
    c_city_i = c_nation_i * 10 + rng.integers(0, 10, nc)
    cities = sorted({f"{nations[i // 10][:9]:<9}{i % 10}" for i in range(250)})
    city_dict = StringDict.from_values(cities)
    c_city = city_dict.encode([f"{nations[i // 10][:9]:<9}{i % 10}" for i in c_city_i])
    out["customer"] = HostTable.from_pydict(
        {
            "c_custkey": c_key,
            "c_name": (StringDict.from_values([f"Customer#{k:09d}" for k in c_key]),
                       np.arange(nc, dtype=np.int32)),
            "c_address": (StringDict.from_values([""]), np.zeros(nc, np.int32)),
            "c_city": (city_dict, c_city),
            "c_nation": [nations[i] for i in c_nation_i],
            "c_region": [REGIONS[nation_region[i]] for i in c_nation_i],
            "c_phone": (StringDict.from_values([""]), np.zeros(nc, np.int32)),
            "c_mktsegment": [
                ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"][i]
                for i in rng.integers(0, 5, nc)
            ],
        },
        types={"c_custkey": T.BIGINT},
    )

    ns = max(int(2_000 * sf), 10)
    s_key = np.arange(1, ns + 1, dtype=np.int64)
    s_nation_i = rng.integers(0, 25, ns)
    s_city_i = s_nation_i * 10 + rng.integers(0, 10, ns)
    s_city = city_dict.encode([f"{nations[i // 10][:9]:<9}{i % 10}" for i in s_city_i])
    out["supplier"] = HostTable.from_pydict(
        {
            "s_suppkey": s_key,
            "s_name": (StringDict.from_values([f"Supplier#{k:09d}" for k in s_key]),
                       np.arange(ns, dtype=np.int32)),
            "s_address": (StringDict.from_values([""]), np.zeros(ns, np.int32)),
            "s_city": (city_dict, s_city),
            "s_nation": [nations[i] for i in s_nation_i],
            "s_region": [REGIONS[nation_region[i]] for i in s_nation_i],
            "s_phone": (StringDict.from_values([""]), np.zeros(ns, np.int32)),
        },
        types={"s_suppkey": T.BIGINT},
    )

    npart = max(int(200_000 * sf), 200)
    p_key = np.arange(1, npart + 1, dtype=np.int64)
    mfgr_i = rng.integers(0, 5, npart)
    cat_i = mfgr_i * 5 + rng.integers(0, 5, npart)
    brand_i = cat_i * 40 + rng.integers(0, 40, npart)
    cats = sorted({f"MFGR#{m + 1}{c + 1}" for m in range(5) for c in range(5)})
    cat_dict = StringDict.from_values(cats)
    cat_codes = cat_dict.encode([f"MFGR#{i // 5 + 1}{i % 5 + 1}" for i in cat_i])
    brands = sorted({f"MFGR#{c // 5 + 1}{c % 5 + 1}{b + 1:02d}" for c in range(25) for b in range(40)})
    brand_dict = StringDict.from_values(brands)
    brand_codes = brand_dict.encode(
        [f"MFGR#{c // 5 + 1}{c % 5 + 1}{b + 1:02d}" for c, b in zip(cat_i, brand_i % 40)]
    )
    out["part"] = HostTable.from_pydict(
        {
            "p_partkey": p_key,
            "p_name": (StringDict.from_values([f"part{i}" for i in range(200)]),
                       (p_key % 200).astype(np.int32)),
            "p_mfgr": [MFGRS[i] for i in mfgr_i],
            "p_category": (cat_dict, cat_codes),
            "p_brand": (brand_dict, brand_codes),
            "p_color": (StringDict.from_values(sorted({
                "red", "green", "blue", "yellow", "purple", "ivory", "olive",
                "peach", "tan", "snow",
            })), rng.integers(0, 10, npart).astype(np.int32)),
            "p_size": rng.integers(1, 51, npart).astype(np.int32),
        },
        types={"p_partkey": T.BIGINT, "p_size": T.INT},
    )

    nlo = max(int(6_000_000 * sf), 1000)
    lo_orderkey = np.arange(1, nlo + 1, dtype=np.int64)
    lo_custkey = rng.integers(1, nc + 1, nlo).astype(np.int64)
    lo_partkey = rng.integers(1, npart + 1, nlo).astype(np.int64)
    lo_suppkey = rng.integers(1, ns + 1, nlo).astype(np.int64)
    lo_date_i = rng.integers(0, nd, nlo)
    lo_qty = rng.integers(1, 51, nlo).astype(np.int32)
    lo_extprice = np.round(rng.uniform(900, 105000, nlo), 2)
    lo_discount = rng.integers(0, 11, nlo).astype(np.int32)
    lo_revenue = np.round(lo_extprice * (100 - lo_discount) / 100, 2)
    lo_supplycost = np.round(lo_extprice * 0.6, 2)

    lo = {
        "lo_orderkey": lo_orderkey,
        "lo_custkey": lo_custkey,
        "lo_partkey": lo_partkey,
        "lo_suppkey": lo_suppkey,
        "lo_orderdate": d_key[lo_date_i],
        "lo_quantity": lo_qty,
        "lo_extendedprice": lo_extprice,
        "lo_discount": lo_discount,
        "lo_revenue": lo_revenue,
        "lo_supplycost": lo_supplycost,
    }
    lo_types = {
        "lo_orderkey": T.BIGINT, "lo_custkey": T.BIGINT, "lo_partkey": T.BIGINT,
        "lo_suppkey": T.BIGINT, "lo_orderdate": T.INT, "lo_quantity": T.INT,
        "lo_extendedprice": DEC, "lo_discount": T.INT, "lo_revenue": DEC,
        "lo_supplycost": DEC,
    }
    out["lineorder"] = HostTable.from_pydict(lo, types=lo_types)

    # --- denormalized lineorder_flat (the SSB-flat headline table) -----------
    flat = dict(lo)
    flat["lo_orderdate_year"] = d_year[lo_date_i]
    flat["lo_orderdate_yearmonthnum"] = d_ymn[lo_date_i].astype(np.int32)
    flat["lo_orderdate_weeknuminyear"] = d_week[lo_date_i]
    ym_dict = StringDict.from_values(sorted(set(d_ym)))
    flat["lo_orderdate_yearmonth"] = (
        ym_dict, ym_dict.encode(d_ym)[lo_date_i].astype(np.int32)
    )
    flat["c_city"] = (city_dict, c_city[lo_custkey - 1])
    c_nation_dict = StringDict.from_values(sorted(set(nations)))
    flat["c_nation"] = (c_nation_dict,
                        c_nation_dict.encode(nations)[c_nation_i[lo_custkey - 1]].astype(np.int32))
    region_dict = StringDict.from_values(sorted(REGIONS))
    region_codes = region_dict.encode(REGIONS)
    flat["c_region"] = (region_dict,
                        region_codes[np.asarray(nation_region)[c_nation_i[lo_custkey - 1]]].astype(np.int32))
    flat["s_city"] = (city_dict, s_city[lo_suppkey - 1])
    flat["s_nation"] = (c_nation_dict,
                        c_nation_dict.encode(nations)[s_nation_i[lo_suppkey - 1]].astype(np.int32))
    flat["s_region"] = (region_dict,
                        region_codes[np.asarray(nation_region)[s_nation_i[lo_suppkey - 1]]].astype(np.int32))
    flat["p_mfgr"] = (StringDict.from_values(sorted(MFGRS)),
                      StringDict.from_values(sorted(MFGRS)).encode(MFGRS)[mfgr_i[lo_partkey - 1]].astype(np.int32))
    flat["p_category"] = (cat_dict, cat_codes[lo_partkey - 1])
    flat["p_brand"] = (brand_dict, brand_codes[lo_partkey - 1])
    flat_types = dict(lo_types)
    flat_types.update({
        "lo_orderdate_year": T.INT, "lo_orderdate_yearmonthnum": T.INT,
        "lo_orderdate_weeknuminyear": T.INT,
    })
    out["lineorder_flat"] = HostTable.from_pydict(flat, types=flat_types)
    return out


SSB_UNIQUE_KEYS = {
    "dates": [("d_datekey",)],
    "customer": [("c_custkey",)],
    "supplier": [("s_suppkey",)],
    "part": [("p_partkey",)],
}


def ssb_catalog(sf: float = 0.01, seed: int = 7):
    from ..catalog import Catalog

    cat = Catalog()
    for name, ht in gen_ssb(sf, seed).items():
        cat.register(name, ht, SSB_UNIQUE_KEYS.get(name, ()))
    return cat
