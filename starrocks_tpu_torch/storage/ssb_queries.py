"""The 13 SSB-flat queries (denormalized lineorder_flat formulation — the
reference's headline SSB benchmark, docs/en/benchmarking/SSB_Benchmarking.md).

The port's own copy of `tests/ssb_queries.py` (a test checks the two agree),
so that a machine without the repo's tests imports it from the package."""

FLAT_QUERIES = {
    "q1.1": """select sum(lo_extendedprice * lo_discount) as revenue
        from lineorder_flat
        where lo_orderdate_year = 1993 and lo_discount between 1 and 3
          and lo_quantity < 25""",
    "q1.2": """select sum(lo_extendedprice * lo_discount) as revenue
        from lineorder_flat
        where lo_orderdate_yearmonthnum = 199401
          and lo_discount between 4 and 6 and lo_quantity between 26 and 35""",
    "q1.3": """select sum(lo_extendedprice * lo_discount) as revenue
        from lineorder_flat
        where lo_orderdate_weeknuminyear = 6 and lo_orderdate_year = 1994
          and lo_discount between 5 and 7 and lo_quantity between 26 and 35""",
    "q2.1": """select sum(lo_revenue) as lo_revenue, lo_orderdate_year as year, p_brand
        from lineorder_flat
        where p_category = 'MFGR#12' and s_region = 'AMERICA'
        group by lo_orderdate_year, p_brand
        order by lo_orderdate_year, p_brand""",
    "q2.2": """select sum(lo_revenue) as lo_revenue, lo_orderdate_year as year, p_brand
        from lineorder_flat
        where p_brand >= 'MFGR#2221' and p_brand <= 'MFGR#2228' and s_region = 'ASIA'
        group by lo_orderdate_year, p_brand
        order by lo_orderdate_year, p_brand""",
    "q2.3": """select sum(lo_revenue) as lo_revenue, lo_orderdate_year as year, p_brand
        from lineorder_flat
        where p_brand = 'MFGR#2239' and s_region = 'EUROPE'
        group by lo_orderdate_year, p_brand
        order by lo_orderdate_year, p_brand""",
    "q3.1": """select c_nation, s_nation, lo_orderdate_year as year,
          sum(lo_revenue) as lo_revenue
        from lineorder_flat
        where c_region = 'ASIA' and s_region = 'ASIA'
          and lo_orderdate_year >= 1992 and lo_orderdate_year <= 1997
        group by c_nation, s_nation, lo_orderdate_year
        order by lo_orderdate_year asc, lo_revenue desc""",
    "q3.2": """select c_city, s_city, lo_orderdate_year as year,
          sum(lo_revenue) as lo_revenue
        from lineorder_flat
        where c_nation = 'UNITED STATES' and s_nation = 'UNITED STATES'
          and lo_orderdate_year >= 1992 and lo_orderdate_year <= 1997
        group by c_city, s_city, lo_orderdate_year
        order by lo_orderdate_year asc, lo_revenue desc""",
    "q3.3": """select c_city, s_city, lo_orderdate_year as year,
          sum(lo_revenue) as lo_revenue
        from lineorder_flat
        where (c_city = 'UNITED KI1' or c_city = 'UNITED KI5')
          and (s_city = 'UNITED KI1' or s_city = 'UNITED KI5')
          and lo_orderdate_year >= 1992 and lo_orderdate_year <= 1997
        group by c_city, s_city, lo_orderdate_year
        order by lo_orderdate_year asc, lo_revenue desc""",
    "q3.4": """select c_city, s_city, lo_orderdate_year as year,
          sum(lo_revenue) as lo_revenue
        from lineorder_flat
        where (c_city = 'UNITED KI1' or c_city = 'UNITED KI5')
          and (s_city = 'UNITED KI1' or s_city = 'UNITED KI5')
          and lo_orderdate_yearmonth = 'Dec1997'
        group by c_city, s_city, lo_orderdate_year
        order by lo_orderdate_year asc, lo_revenue desc""",
    "q4.1": """select lo_orderdate_year as year, c_nation,
          sum(lo_revenue - lo_supplycost) as profit
        from lineorder_flat
        where c_region = 'AMERICA' and s_region = 'AMERICA'
          and (p_mfgr = 'MFGR#1' or p_mfgr = 'MFGR#2')
        group by lo_orderdate_year, c_nation
        order by lo_orderdate_year, c_nation""",
    "q4.2": """select lo_orderdate_year as year, s_nation, p_category,
          sum(lo_revenue - lo_supplycost) as profit
        from lineorder_flat
        where c_region = 'AMERICA' and s_region = 'AMERICA'
          and (lo_orderdate_year = 1997 or lo_orderdate_year = 1998)
          and (p_mfgr = 'MFGR#1' or p_mfgr = 'MFGR#2')
        group by lo_orderdate_year, s_nation, p_category
        order by lo_orderdate_year, s_nation, p_category""",
    "q4.3": """select lo_orderdate_year as year, s_city, p_brand,
          sum(lo_revenue - lo_supplycost) as profit
        from lineorder_flat
        where s_nation = 'UNITED STATES'
          and (lo_orderdate_year = 1997 or lo_orderdate_year = 1998)
          and p_category = 'MFGR#14'
        group by lo_orderdate_year, s_city, p_brand
        order by lo_orderdate_year, s_city, p_brand""",
}


# The native filter-sum lane's queries (`SET segment_strategy = 'native'`):
# q1.1-q1.3 with the sum taken over integer columns, so that every column
# they read is an integer (lo_extendedprice is a DECIMAL(15,2), and the
# lane takes integers only); the predicates are kept as they are.
NATIVE_QUERIES = {
    f"NL{i}": FLAT_QUERIES[f"q1.{i}"].replace(
        "sum(lo_extendedprice * lo_discount)",
        "sum(lo_quantity * lo_discount)")
    for i in (1, 2, 3)
}
