"""The query texts the port is driven with: the 22 TPC-H queries and two
statistical queries over the TPC-H schema.

`QUERIES` is the port's own copy of the 22 TPC-H queries (validation
parameters) as the repo's tests hold them (tests/tpch_queries.py; a test
checks the two copies agree): MySQL-style substring(x, start, len), and a
CTE instead of the Q15 view.

`STAT_QUERIES` holds the statistical aggregates, whose float moment sums
reach the segment-sum kernel under `segment_strategy = 'pallas'`:
S1 is the reference's own flag-flip gate query for that strategy, S2 a
Q1-shaped query over the whole variance and covariance family.

`TOPN_QUERIES` holds plain `ORDER BY .. LIMIT` queries over the fact
tables' base columns, whose ORDER BY keys pack into one int64: under
`topn_strategy = 'pallas'` they reach the top-N kernel at the table's
whole capacity. N1 sorts on a 53-bit key without ties (at SF 10), N2 on a
6-bit key with about 1/50 of lineitem tied at the top, N3 a filtered input
(its dead rows pack to the largest key) with a LIMIT near the kernel's k.

`BREADTH_QUERIES` drive the SQL surface beyond TPC-H: UNION ALL (B1),
INTERSECT (B2), EXCEPT (B3), UNION with a FROM-less row (B4), DECIMAL(38)
sums of products, minima and maxima (B5), group_concat (B6), the numeric
and date functions (B7), and the string functions with IF, NULLIF and an
ORDER BY .. LIMIT (B8).
"""


QUERIES = {
1: """
select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
  sum(l_extendedprice) as sum_base_price,
  sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
  sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
  avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
  avg(l_discount) as avg_disc, count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
""",
2: """
select s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone, s_comment
from part, supplier, partsupp, nation, region
where p_partkey = ps_partkey and s_suppkey = ps_suppkey and p_size = 15
  and p_type like '%BRASS' and s_nationkey = n_nationkey and n_regionkey = r_regionkey
  and r_name = 'EUROPE'
  and ps_supplycost = (
    select min(ps_supplycost) from partsupp, supplier, nation, region
    where p_partkey = ps_partkey and s_suppkey = ps_suppkey
      and s_nationkey = n_nationkey and n_regionkey = r_regionkey and r_name = 'EUROPE')
order by s_acctbal desc, n_name, s_name, p_partkey
limit 100
""",
3: """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
  o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey and l_orderkey = o_orderkey
  and o_orderdate < date '1995-03-15' and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
""",
4: """
select o_orderpriority, count(*) as order_count
from orders
where o_orderdate >= date '1993-07-01'
  and o_orderdate < date '1993-07-01' + interval '3' month
  and exists (select * from lineitem
              where l_orderkey = o_orderkey and l_commitdate < l_receiptdate)
group by o_orderpriority
order by o_orderpriority
""",
5: """
select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
from customer, orders, lineitem, supplier, nation, region
where c_custkey = o_custkey and l_orderkey = o_orderkey and l_suppkey = s_suppkey
  and c_nationkey = s_nationkey and s_nationkey = n_nationkey
  and n_regionkey = r_regionkey and r_name = 'ASIA'
  and o_orderdate >= date '1994-01-01' and o_orderdate < date '1995-01-01'
group by n_name
order by revenue desc
""",
6: """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1994-01-01' + interval '1' year
  and l_discount between 0.05 and 0.07 and l_quantity < 24
""",
7: """
select supp_nation, cust_nation, l_year, sum(volume) as revenue
from (
  select n1.n_name as supp_nation, n2.n_name as cust_nation,
    extract(year from l_shipdate) as l_year,
    l_extendedprice * (1 - l_discount) as volume
  from supplier, lineitem, orders, customer, nation n1, nation n2
  where s_suppkey = l_suppkey and o_orderkey = l_orderkey and c_custkey = o_custkey
    and s_nationkey = n1.n_nationkey and c_nationkey = n2.n_nationkey
    and ((n1.n_name = 'FRANCE' and n2.n_name = 'GERMANY')
      or (n1.n_name = 'GERMANY' and n2.n_name = 'FRANCE'))
    and l_shipdate between date '1995-01-01' and date '1996-12-31'
) shipping
group by supp_nation, cust_nation, l_year
order by supp_nation, cust_nation, l_year
""",
8: """
select o_year, sum(case when nation = 'BRAZIL' then volume else 0 end) / sum(volume) as mkt_share
from (
  select extract(year from o_orderdate) as o_year,
    l_extendedprice * (1 - l_discount) as volume, n2.n_name as nation
  from part, supplier, lineitem, orders, customer, nation n1, nation n2, region
  where p_partkey = l_partkey and s_suppkey = l_suppkey and l_orderkey = o_orderkey
    and o_custkey = c_custkey and c_nationkey = n1.n_nationkey
    and n1.n_regionkey = r_regionkey and r_name = 'AMERICA'
    and s_nationkey = n2.n_nationkey
    and o_orderdate between date '1995-01-01' and date '1996-12-31'
    and p_type = 'ECONOMY ANODIZED STEEL'
) all_nations
group by o_year
order by o_year
""",
9: """
select nation, o_year, sum(amount) as sum_profit
from (
  select n_name as nation, extract(year from o_orderdate) as o_year,
    l_extendedprice * (1 - l_discount) - ps_supplycost * l_quantity as amount
  from part, supplier, lineitem, partsupp, orders, nation
  where s_suppkey = l_suppkey and ps_suppkey = l_suppkey and ps_partkey = l_partkey
    and p_partkey = l_partkey and o_orderkey = l_orderkey and s_nationkey = n_nationkey
    and p_name like '%green%'
) profit
group by nation, o_year
order by nation, o_year desc
""",
10: """
select c_custkey, c_name, sum(l_extendedprice * (1 - l_discount)) as revenue,
  c_acctbal, n_name, c_address, c_phone, c_comment
from customer, orders, lineitem, nation
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and o_orderdate >= date '1993-10-01'
  and o_orderdate < date '1993-10-01' + interval '3' month
  and l_returnflag = 'R' and c_nationkey = n_nationkey
group by c_custkey, c_name, c_acctbal, c_phone, n_name, c_address, c_comment
order by revenue desc
limit 20
""",
11: """
select ps_partkey, sum(ps_supplycost * ps_availqty) as value
from partsupp, supplier, nation
where ps_suppkey = s_suppkey and s_nationkey = n_nationkey and n_name = 'GERMANY'
group by ps_partkey
having sum(ps_supplycost * ps_availqty) > (
  select sum(ps_supplycost * ps_availqty) * 0.0001
  from partsupp, supplier, nation
  where ps_suppkey = s_suppkey and s_nationkey = n_nationkey and n_name = 'GERMANY')
order by value desc
""",
12: """
select l_shipmode,
  sum(case when o_orderpriority = '1-URGENT' or o_orderpriority = '2-HIGH'
      then 1 else 0 end) as high_line_count,
  sum(case when o_orderpriority <> '1-URGENT' and o_orderpriority <> '2-HIGH'
      then 1 else 0 end) as low_line_count
from orders, lineitem
where o_orderkey = l_orderkey and l_shipmode in ('MAIL', 'SHIP')
  and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
  and l_receiptdate >= date '1994-01-01'
  and l_receiptdate < date '1994-01-01' + interval '1' year
group by l_shipmode
order by l_shipmode
""",
13: """
select c_count, count(*) as custdist
from (
  select c_custkey, count(o_orderkey) as c_count
  from customer left outer join orders on c_custkey = o_custkey
    and o_comment not like '%special%requests%'
  group by c_custkey
) c_orders
group by c_count
order by custdist desc, c_count desc
""",
14: """
select 100.00 * sum(case when p_type like 'PROMO%'
    then l_extendedprice * (1 - l_discount) else 0 end)
  / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
from lineitem, part
where l_partkey = p_partkey and l_shipdate >= date '1995-09-01'
  and l_shipdate < date '1995-09-01' + interval '1' month
""",
15: """
with revenue0 as (
  select l_suppkey as supplier_no, sum(l_extendedprice * (1 - l_discount)) as total_revenue
  from lineitem
  where l_shipdate >= date '1996-01-01'
    and l_shipdate < date '1996-01-01' + interval '3' month
  group by l_suppkey
)
select s_suppkey, s_name, s_address, s_phone, total_revenue
from supplier, revenue0
where s_suppkey = supplier_no
  and total_revenue = (select max(total_revenue) from revenue0)
order by s_suppkey
""",
16: """
select p_brand, p_type, p_size, count(distinct ps_suppkey) as supplier_cnt
from partsupp, part
where p_partkey = ps_partkey and p_brand <> 'Brand#45'
  and p_type not like 'MEDIUM POLISHED%' and p_size in (49, 14, 23, 45, 19, 3, 36, 9)
  and ps_suppkey not in (
    select s_suppkey from supplier where s_comment like '%Customer%Complaints%')
group by p_brand, p_type, p_size
order by supplier_cnt desc, p_brand, p_type, p_size
""",
17: """
select sum(l_extendedprice) / 7.0 as avg_yearly
from lineitem, part
where p_partkey = l_partkey and p_brand = 'Brand#23' and p_container = 'MED BOX'
  and l_quantity < (
    select 0.2 * avg(l_quantity) from lineitem where l_partkey = p_partkey)
""",
18: """
select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice, sum(l_quantity)
from customer, orders, lineitem
where o_orderkey in (
    select l_orderkey from lineitem group by l_orderkey having sum(l_quantity) > 300)
  and c_custkey = o_custkey and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate
limit 100
""",
19: """
select sum(l_extendedprice * (1 - l_discount)) as revenue
from lineitem, part
where (p_partkey = l_partkey and p_brand = 'Brand#12'
    and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
    and l_quantity >= 1 and l_quantity <= 11 and p_size between 1 and 5
    and l_shipmode in ('AIR', 'AIR REG') and l_shipinstruct = 'DELIVER IN PERSON')
  or (p_partkey = l_partkey and p_brand = 'Brand#23'
    and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
    and l_quantity >= 10 and l_quantity <= 20 and p_size between 1 and 10
    and l_shipmode in ('AIR', 'AIR REG') and l_shipinstruct = 'DELIVER IN PERSON')
  or (p_partkey = l_partkey and p_brand = 'Brand#34'
    and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
    and l_quantity >= 20 and l_quantity <= 30 and p_size between 1 and 15
    and l_shipmode in ('AIR', 'AIR REG') and l_shipinstruct = 'DELIVER IN PERSON')
""",
20: """
select s_name, s_address
from supplier, nation
where s_suppkey in (
    select ps_suppkey from partsupp
    where ps_partkey in (select p_partkey from part where p_name like 'forest%')
      and ps_availqty > (
        select 0.5 * sum(l_quantity) from lineitem
        where l_partkey = ps_partkey and l_suppkey = ps_suppkey
          and l_shipdate >= date '1994-01-01'
          and l_shipdate < date '1994-01-01' + interval '1' year))
  and s_nationkey = n_nationkey and n_name = 'CANADA'
order by s_name
""",
21: """
select s_name, count(*) as numwait
from supplier, lineitem l1, orders, nation
where s_suppkey = l1.l_suppkey and o_orderkey = l1.l_orderkey and o_orderstatus = 'F'
  and l1.l_receiptdate > l1.l_commitdate
  and exists (select * from lineitem l2
              where l2.l_orderkey = l1.l_orderkey and l2.l_suppkey <> l1.l_suppkey)
  and not exists (select * from lineitem l3
                  where l3.l_orderkey = l1.l_orderkey and l3.l_suppkey <> l1.l_suppkey
                    and l3.l_receiptdate > l3.l_commitdate)
  and s_nationkey = n_nationkey and n_name = 'SAUDI ARABIA'
group by s_name
order by numwait desc, s_name
limit 100
""",
22: """
select cntrycode, count(*) as numcust, sum(c_acctbal) as totacctbal
from (
  select substring(c_phone, 1, 2) as cntrycode, c_acctbal
  from customer
  where substring(c_phone, 1, 2) in ('13', '31', '23', '29', '30', '18', '17')
    and c_acctbal > (
      select avg(c_acctbal) from customer
      where c_acctbal > 0.00
        and substring(c_phone, 1, 2) in ('13', '31', '23', '29', '30', '18', '17'))
    and not exists (select * from orders where o_custkey = c_custkey)
) custsale
group by cntrycode
order by cntrycode
""",
}

STAT_QUERIES = {
"S1": """
select l_returnflag, avg(l_discount) a, var_samp(l_discount) v
from lineitem group by l_returnflag
""",
"S2": """
select l_returnflag, l_linestatus, stddev_samp(l_quantity) sq,
  var_pop(l_extendedprice) vp, covar_samp(l_quantity, l_extendedprice) cv,
  corr(l_quantity, l_extendedprice) cr, count(*) c
from lineitem
where l_shipdate <= date '1998-09-02'
group by l_returnflag, l_linestatus
order by 1, 2
""",
}

TOPN_QUERIES = {
"N1": """
SELECT l_orderkey, l_linenumber, l_extendedprice FROM lineitem ORDER BY l_extendedprice DESC, l_orderkey, l_linenumber LIMIT 100
""",
"N2": """
SELECT l_orderkey, l_linenumber, l_quantity FROM lineitem ORDER BY l_quantity DESC LIMIT 100
""",
"N3": """
SELECT o_orderkey, o_custkey, o_totalprice, o_orderdate FROM orders WHERE o_orderdate >= DATE '1995-01-01' ORDER BY o_totalprice DESC, o_orderkey LIMIT 1000
""",
}


BREADTH_QUERIES = {
    "B1": """
select l_returnflag, count(*) c, sum(l_quantity) q from (
  select l_returnflag, l_quantity from lineitem where l_shipdate < date '1993-01-01'
  union all
  select l_returnflag, l_quantity from lineitem where l_shipdate >= date '1998-01-01') u
group by l_returnflag order by l_returnflag
""",
    "B2": """
select count(*) c from (
  select o_custkey k from orders where o_orderpriority = '1-URGENT'
  intersect
  select c_custkey k from customer where c_mktsegment = 'BUILDING') t
""",
    "B3": """
select count(*) c from (
  select o_custkey k from orders where o_orderpriority = '1-URGENT'
  except
  select c_custkey k from customer where c_mktsegment = 'BUILDING') t
""",
    "B4": """
select l_shipmode, n from (
  select l_shipmode, count(*) n from lineitem group by l_shipmode
  union select 'NONE', 0) t
order by l_shipmode
""",
    "B5": """
select l_returnflag,
  sum(cast(l_extendedprice as decimal(38,2)) * cast(l_quantity as decimal(38,2))) s,
  min(cast(l_extendedprice as decimal(38,4))) mn,
  max(cast(l_extendedprice as decimal(38,4))) mx
from lineitem group by l_returnflag order by l_returnflag
""",
    "B6": """
select n_regionkey, group_concat(n_name order by n_name separator ',') g
from nation group by n_regionkey order by n_regionkey
""",
    "B7": """
select l_shipmode, count(*) c, sum(mod(l_orderkey, 7)) m,
  max(abs(l_discount - 0.05)) d, round(avg(sqrt(l_quantity)), 4) s,
  min(datediff(l_receiptdate, l_shipdate)) dd, max(quarter(l_shipdate)) qq,
  max(month(l_shipdate)) mm, min(dayofweek(l_shipdate)) dw,
  max(length(l_comment)) ln,
  sum(greatest(l_quantity, 10) - least(l_quantity, 40)) gl,
  sum(floor(l_extendedprice / 1000) + ceil(l_tax * 10)) fc,
  round(sum(power(l_discount, 2) + exp(0 - l_tax) + ln(l_quantity)), 3) pe
from lineitem
where starts_with(l_shipmode, 'R') or ends_with(l_shipmode, 'L') or l_shipmode = 'TRUCK'
group by l_shipmode order by l_shipmode
""",
    "B8": """
select upper(l_shipinstruct) ui, lower(l_shipmode) lm,
  trim(replace(l_shipinstruct, 'DELIVER', ' ')) t, count(*) c,
  sum(if(l_returnflag = 'R', 1, 0)) r, count(nullif(l_linenumber, 1)) n1
from lineitem
group by upper(l_shipinstruct), lower(l_shipmode), trim(replace(l_shipinstruct, 'DELIVER', ' '))
order by ui, lm limit 50
""",
}


# The rest of the scalar-function surface over TPC-H (slice 5b): the
# function waves, arrays, unnest, lambdas/MAP/STRUCT, sketches, the
# percentiles, array_agg and a Python UDF. F9 and F10 run over `supplier`:
# a per-row Python UDF over lineitem would be minutes of host time.
# F10 needs FUNCTION_UDF registered first.
FUNCTION_UDF = (
    "create function f_udf(a bigint, b double) returns double as "
    "'def f_udf(a, b):\n    return (a % 13) * b + 0.5\n'")

FUNCTION_QUERIES = {
    "F1": """
select l_returnflag, l_linestatus,
  sum(cbrt(l_extendedprice) + log2(l_quantity + 1) + atan2(l_discount, l_tax + 0.01)) s,
  sum(pmod(l_orderkey, 7) + bit_count(l_partkey)) p,
  count(distinct weekofyear(l_shipdate)) w,
  max(datediff(last_day(l_receiptdate), l_shipdate)) d
from lineitem group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus
""",
    "F2": """
select substring_index(l_shipinstruct, ' ', 1) w, lpad(l_shipmode, 8, '*') m,
  count(*) c, max(murmur_hash3_32(l_shipmode)) h, sum(char_length(l_shipinstruct)) n,
  min(xx_hash64(l_shipinstruct)) x
from lineitem where l_shipdate >= date '1995-01-01' group by 1, 2 order by 1, 2
""",
    "F3": """
select l_orderkey, l_linenumber, dayname(l_shipdate) d, lpad(l_shipmode, 8, '*') m,
  bitxor(l_orderkey * 7919, l_partkey) h
from lineitem order by l_extendedprice desc, l_orderkey, l_linenumber limit 100
""",
    "F4": """
select l_returnflag, sum(array_sum(array(l_quantity, l_linenumber, l_suppkey))) s,
  max(array_max(array(l_quantity, l_linenumber))) m,
  sum(cardinality(split(l_shipinstruct, ' '))) c,
  sum(array_position(array_sort(array(l_linenumber, 3, 5)), 3)) p
from lineitem group by l_returnflag order by l_returnflag
""",
    "F5": """
select w, count(*) c, sum(l_quantity) q
from lineitem, unnest(split(l_shipinstruct, ' ')) u(w) group by w order by w
""",
    "F6": """
select l_linestatus,
  sum(array_sum(array_map(x -> x * 2 + 1, array(l_quantity, l_linenumber)))) a,
  sum(case when any_match(x -> x > 45, array(l_quantity, l_suppkey % 50)) then 1 else 0 end) b,
  sum(element_at(map_from_arrays(array('q', 'n'), array(l_quantity, l_linenumber)), 'n')) c,
  sum(struct_field(named_struct('k', l_partkey, 'q', l_quantity), 'q')) d
from lineitem group by l_linestatus order by l_linestatus
""",
    "F7": """
select l_returnflag, approx_count_distinct(l_partkey) a,
  bitmap_union_count(to_bitmap(l_suppkey)) c
from lineitem group by l_returnflag order by l_returnflag
""",
    "F8": """
select l_shipmode, percentile_cont(l_extendedprice, 0.5) p50, median(l_discount) md,
  percentile_disc(l_quantity, 0.9) p90
from lineitem group by l_shipmode order by l_shipmode
""",
    "F9": """
select s_nationkey, array_length(array_agg(s_suppkey)) n, array_max(array_agg(s_acctbal)) m
from supplier group by s_nationkey order by s_nationkey
""",
    "F10": """
select s_nationkey, sum(f_udf(s_suppkey, s_acctbal)) u, count(*) c
from supplier group by s_nationkey order by s_nationkey
""",
    "F11": """
select l_shipmode,
  sum(l2_distance(array(l_quantity, l_linenumber), array(l_suppkey % 50, 3))) l2,
  sum(cosine_similarity(array(l_quantity, l_linenumber), array(l_suppkey % 50, 3))) cs,
  max(regexp_count(l_shipinstruct, 'E')) rc
from lineitem group by l_shipmode order by l_shipmode
""",
}


# Execution beyond device memory (runtime/batched.py): with
# `batch_rows_threshold` set below a table's rows, each of these takes a
# spill executor. Batched aggregation: Q1, Q6, S1, S2, B7 (B7's DOUBLE sums
# and S1/S2's moment sums reach segment_sum under the kernel strategies);
# the hybrid partitioned join (one integer equi key, a scan on each side):
# Q4, Q12, Q14, Q19; the spilled sort (host lexsort of device-evaluated
# operands): N1, N3; the spilled window (rows hash-split by PARTITION BY):
# W1, ~100 rows a unit of scale factor.
SPILL_WINDOW_QUERIES = {
"W1": """
SELECT l_orderkey, l_linenumber, row_number() OVER (PARTITION BY l_orderkey ORDER BY l_extendedprice DESC, l_linenumber) rn, sum(l_quantity) OVER (PARTITION BY l_orderkey ORDER BY l_linenumber) rq FROM lineitem WHERE l_shipdate >= DATE '1998-06-01'
""",
}

SPILL_QUERIES = {
    **{f"Q{q}": QUERIES[q] for q in (1, 6)},
    "S1": STAT_QUERIES["S1"],
    "S2": STAT_QUERIES["S2"],
    "B7": BREADTH_QUERIES["B7"],
    **{f"Q{q}": QUERIES[q] for q in (4, 12, 14, 19)},
    "N1": TOPN_QUERIES["N1"],
    "N3": TOPN_QUERIES["N3"],
    **SPILL_WINDOW_QUERIES,
}
# the executor each spill query takes (its profile node)
SPILL_EXECUTORS = {
    **{q: "batched" for q in ("Q1", "Q6", "S1", "S2", "B7")},
    **{q: "hybrid" for q in ("Q4", "Q12", "Q14", "Q19")},
    "N1": "spill_sort", "N3": "spill_sort", "W1": "spill_window",
}

# The distributed path (Session(dist_shards=n)): the JAX package's
# distributed TPC-H set (tests/test_distributed_sql.py DIST_TPCH), the
# float-moment and top-N queries that reach the kernels per shard, its
# PARTITION BY window (shuffled by partition key) and a full ORDER BY over
# a filtered lineitem (the range exchange)
DIST_WINDOW_QUERIES = {
    "W2": """
select l_orderkey, l_linenumber,
       sum(l_quantity) over (partition by l_orderkey
                             order by l_linenumber) rq,
       row_number() over (partition by l_orderkey
                          order by l_extendedprice desc) rn
from lineitem where l_orderkey < 1000
""",
}
DIST_QUERIES = {
    **{f"Q{q}": QUERIES[q] for q in (1, 3, 5, 6, 10, 12, 14, 18, 19)},
    "S1": STAT_QUERIES["S1"],
    "S2": STAT_QUERIES["S2"],
    "N1": TOPN_QUERIES["N1"],
    **DIST_WINDOW_QUERIES,
    "O1": """
select l_extendedprice from lineitem
where l_quantity = 50 and l_discount = 0.10
order by l_extendedprice desc
""",
}
