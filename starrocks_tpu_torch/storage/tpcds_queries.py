"""TPC-DS query texts (the port's own copy, so that a machine without the
repo's tests imports them from the package; a test holds them equal to
`tests/tpcds_queries.py` and `tests/test_tpcds_q67.py`).

Shapes follow the official qualification queries (the reference runs all 99:
docs/en/benchmarking/TPC_DS_Benchmark.md); literals are adjusted to this
repo's synthetic datagen value domains (storage/datagen/tpcds.py), and a few
columns absent from the generated schema subset are substituted with
same-typed siblings (noted per query). Query numbers match the spec.

- QUERIES: 98 queries (q1-q99 without q67).
- Q67: q67 (ROLLUP, then rank() filtered to rk <= 10: the window top-N).
- ALL_QUERIES: the 99.
- WINDOW_QUERIES: the 15 that plan an LWindow.
- KERNEL_QUERIES: the queries that launch a kernel under the kernel
  strategies ({query: kernels}, measured by counting each wrapper's calls
  at SF 0.01 on the CPU); SEGMENT_SUM_QUERIES: those that launch
  segment_sum, whose float cells are f32 block sums (the reference's
  contract) and agree with `auto`'s f64 sums to a relative 1e-4 only.
"""

QUERIES = {}

QUERIES["q3"] = """
select d_year, i_brand_id brand_id, i_brand brand,
       sum(ss_ext_sales_price) sum_agg
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
  and store_sales.ss_item_sk = item.i_item_sk
  and item.i_manufact_id = 7
  and dt.d_moy = 11
group by d_year, i_brand_id, i_brand
order by d_year, sum_agg desc, brand_id
limit 100
"""

QUERIES["q7"] = """
select i_item_id,
       avg(ss_quantity) agg1, avg(ss_list_price) agg2,
       avg(ss_coupon_amt) agg3, avg(ss_sales_price) agg4
from store_sales, customer_demographics, date_dim, item, promotion
where ss_sold_date_sk = d_date_sk
  and ss_item_sk = i_item_sk
  and ss_cdemo_sk = cd_demo_sk
  and ss_promo_sk = p_promo_sk
  and cd_gender = 'M' and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and (p_channel_email = 'N' or p_channel_event = 'N')
  and d_year = 2000
group by i_item_id
order by i_item_id
limit 100
"""

QUERIES["q12"] = """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(ws_ext_sales_price) itemrevenue,
       sum(ws_ext_sales_price) * 100 /
         sum(sum(ws_ext_sales_price)) over (partition by i_class)
         revenueratio
from web_sales, item, date_dim
where ws_item_sk = i_item_sk
  and i_category in ('Sports', 'Books', 'Home')
  and ws_sold_date_sk = d_date_sk
  and d_year = 1999 and d_moy in (2, 3)
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100
"""

QUERIES["q15"] = """
select ca_zip, sum(cs_sales_price) total
from catalog_sales, customer, customer_address, date_dim
where cs_bill_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and (substr(ca_zip, 1, 2) in ('10', '22', '34', '85')
       or ca_state in ('CA', 'GA')
       or cs_sales_price > 90)
  and cs_sold_date_sk = d_date_sk
  and d_qoy = 2 and d_year = 2001
group by ca_zip
order by ca_zip
limit 100
"""

QUERIES["q19"] = """
select i_brand_id brand_id, i_brand brand, i_manufact_id, i_manufact,
       sum(ss_ext_sales_price) ext_price
from date_dim, store_sales, item, customer, customer_address, store
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 8
  and d_moy = 11 and d_year = 1998
  and ss_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and ss_store_sk = s_store_sk
  and ca_city <> s_city
group by i_brand_id, i_brand, i_manufact_id, i_manufact
order by ext_price desc, brand_id, i_manufact_id
limit 100
"""

QUERIES["q21"] = """
select w_warehouse_name, i_item_id,
       sum(case when d_date < date '2000-03-11'
                then inv_quantity_on_hand else 0 end) inv_before,
       sum(case when d_date >= date '2000-03-11'
                then inv_quantity_on_hand else 0 end) inv_after
from inventory, warehouse, item, date_dim
where i_item_sk = inv_item_sk
  and inv_warehouse_sk = w_warehouse_sk
  and inv_date_sk = d_date_sk
  and i_current_price between 10 and 60
  and d_date between date '2000-02-10' and date '2000-04-10'
group by w_warehouse_name, i_item_id
having sum(case when d_date < date '2000-03-11'
                then inv_quantity_on_hand else 0 end) > 0
   and sum(case when d_date >= date '2000-03-11'
                then inv_quantity_on_hand else 0 end) * 3 >=
       sum(case when d_date < date '2000-03-11'
                then inv_quantity_on_hand else 0 end) * 2
   and sum(case when d_date < date '2000-03-11'
                then inv_quantity_on_hand else 0 end) * 3 >=
       sum(case when d_date >= date '2000-03-11'
                then inv_quantity_on_hand else 0 end) * 2
order by w_warehouse_name, i_item_id
limit 100
"""

QUERIES["q22"] = """
select i_product_name, i_brand, i_class, i_category,
       avg(inv_quantity_on_hand) qoh
from inventory, date_dim, item
where inv_date_sk = d_date_sk
  and inv_item_sk = i_item_sk
  and d_month_seq between 24 and 35
group by rollup(i_product_name, i_brand, i_class, i_category)
order by qoh, i_product_name, i_brand, i_class, i_category
limit 10000
"""

QUERIES["q26"] = """
select i_item_id,
       avg(cs_quantity) agg1, avg(cs_list_price) agg2,
       avg(cs_coupon_amt) agg3, avg(cs_sales_price) agg4
from catalog_sales, customer_demographics, date_dim, item, promotion
where cs_sold_date_sk = d_date_sk
  and cs_item_sk = i_item_sk
  and cs_bill_cdemo_sk = cd_demo_sk
  and cs_promo_sk = p_promo_sk
  and cd_gender = 'F' and cd_marital_status = 'W'
  and cd_education_status = 'Primary'
  and (p_channel_email = 'N' or p_channel_event = 'N')
  and d_year = 2000
group by i_item_id
order by i_item_id
limit 100
"""

QUERIES["q27"] = """
select i_item_id, s_state, grouping(s_state) g_state,
       avg(ss_quantity) agg1, avg(ss_list_price) agg2,
       avg(ss_coupon_amt) agg3, avg(ss_sales_price) agg4
from store_sales, customer_demographics, date_dim, store, item
where ss_sold_date_sk = d_date_sk
  and ss_item_sk = i_item_sk
  and ss_store_sk = s_store_sk
  and ss_cdemo_sk = cd_demo_sk
  and cd_gender = 'M' and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and d_year = 2002
group by rollup(i_item_id, s_state)
order by i_item_id, s_state
limit 10000
"""

QUERIES["q36"] = """
select sum(ss_net_profit) / sum(ss_ext_sales_price) gross_margin,
       i_category, i_class,
       grouping(i_category) + grouping(i_class) lochierarchy,
       rank() over (
         partition by grouping(i_category) + grouping(i_class),
                      case when grouping(i_class) = 1
                           then i_category end
         order by sum(ss_net_profit) / sum(ss_ext_sales_price) asc
       ) rank_within_parent
from store_sales, date_dim, item, store
where d_year = 2001
  and d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk
  and s_store_sk = ss_store_sk
  and s_state in ('TN', 'CA', 'NY', 'TX')
group by rollup(i_category, i_class)
order by lochierarchy desc, i_category, i_class, rank_within_parent
limit 10000
"""

QUERIES["q42"] = """
select d_year, i_category_id, i_category, sum(ss_ext_sales_price) s
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
  and store_sales.ss_item_sk = item.i_item_sk
  and item.i_manager_id = 1
  and dt.d_moy = 11 and dt.d_year = 2000
group by d_year, i_category_id, i_category
order by s desc, d_year, i_category_id, i_category
limit 100
"""

QUERIES["q43"] = """
select s_store_name, s_store_id,
  sum(case when d_day_name = 'Sunday' then ss_sales_price else null end) sun_sales,
  sum(case when d_day_name = 'Monday' then ss_sales_price else null end) mon_sales,
  sum(case when d_day_name = 'Tuesday' then ss_sales_price else null end) tue_sales,
  sum(case when d_day_name = 'Wednesday' then ss_sales_price else null end) wed_sales,
  sum(case when d_day_name = 'Thursday' then ss_sales_price else null end) thu_sales,
  sum(case when d_day_name = 'Friday' then ss_sales_price else null end) fri_sales,
  sum(case when d_day_name = 'Saturday' then ss_sales_price else null end) sat_sales
from date_dim, store_sales, store
where d_date_sk = ss_sold_date_sk
  and s_store_sk = ss_store_sk
  and s_gmt_offset = -5
  and d_year = 2000
group by s_store_name, s_store_id
order by s_store_name, s_store_id, sun_sales, mon_sales, tue_sales,
         wed_sales, thu_sales, fri_sales, sat_sales
limit 100
"""

QUERIES["q52"] = """
select d_year, i_brand_id brand_id, i_brand brand,
       sum(ss_ext_sales_price) ext_price
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
  and store_sales.ss_item_sk = item.i_item_sk
  and item.i_manager_id = 1
  and dt.d_moy = 11 and dt.d_year = 2000
group by d_year, i_brand_id, i_brand
order by d_year, ext_price desc, brand_id
limit 100
"""

QUERIES["q53"] = """
select * from (
  select i_manufact_id,
         sum(ss_sales_price) sum_sales,
         avg(sum(ss_sales_price)) over (partition by i_manufact_id) avg_quarterly_sales
  from item, store_sales, date_dim, store
  where ss_item_sk = i_item_sk
    and ss_sold_date_sk = d_date_sk
    and ss_store_sk = s_store_sk
    and d_month_seq in (24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35)
    and i_category in ('Books', 'Children', 'Electronics')
  group by i_manufact_id, d_qoy
) tmp1
where case when avg_quarterly_sales > 0
           then abs(sum_sales - avg_quarterly_sales) / avg_quarterly_sales
           else null end > 0.1
order by avg_quarterly_sales, sum_sales, i_manufact_id
limit 100
"""

QUERIES["q55"] = """
select i_brand_id brand_id, i_brand brand,
       sum(ss_ext_sales_price) ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 28
  and d_moy = 11 and d_year = 1999
group by i_brand_id, i_brand
order by ext_price desc, brand_id
limit 100
"""

QUERIES["q62"] = """
select w_warehouse_name, sm_type, web_name,
  sum(case when (ws_ship_date_sk - ws_sold_date_sk <= 30) then 1 else 0 end)
    as d30,
  sum(case when (ws_ship_date_sk - ws_sold_date_sk > 30)
            and (ws_ship_date_sk - ws_sold_date_sk <= 60) then 1 else 0 end)
    as d60,
  sum(case when (ws_ship_date_sk - ws_sold_date_sk > 60)
            and (ws_ship_date_sk - ws_sold_date_sk <= 90) then 1 else 0 end)
    as d90,
  sum(case when (ws_ship_date_sk - ws_sold_date_sk > 90) then 1 else 0 end)
    as d120
from web_sales, warehouse, ship_mode, web_site, date_dim
where d_month_seq between 24 and 35
  and ws_ship_date_sk = d_date_sk
  and ws_warehouse_sk = w_warehouse_sk
  and ws_ship_mode_sk = sm_ship_mode_sk
  and ws_web_site_sk = web_site_sk
group by w_warehouse_name, sm_type, web_name
order by w_warehouse_name, sm_type, web_name
limit 100
"""

QUERIES["q89"] = """
select * from (
  select i_category, i_class, i_brand, s_store_name, s_city, d_moy,
         sum(ss_sales_price) sum_sales,
         avg(sum(ss_sales_price)) over (
           partition by i_category, i_brand, s_store_name, s_city
         ) avg_monthly_sales
  from item, store_sales, date_dim, store
  where ss_item_sk = i_item_sk
    and ss_sold_date_sk = d_date_sk
    and ss_store_sk = s_store_sk
    and d_year = 1999
    and ((i_category in ('Books', 'Electronics', 'Sports')
          and i_class in ('class01', 'class03', 'class05'))
      or (i_category in ('Men', 'Jewelry', 'Women')
          and i_class in ('class02', 'class04', 'class06')))
  group by i_category, i_class, i_brand, s_store_name, s_city, d_moy
) tmp1
where case when avg_monthly_sales <> 0
           then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
           else null end > 0.1
order by sum_sales - avg_monthly_sales, s_store_name
limit 10000
"""

QUERIES["q96"] = """
select count(*) cnt
from store_sales, household_demographics, time_dim, store
where ss_sold_time_sk = time_dim.t_time_sk
  and ss_hdemo_sk = household_demographics.hd_demo_sk
  and ss_store_sk = s_store_sk
  and time_dim.t_hour = 20
  and time_dim.t_minute >= 30
  and household_demographics.hd_dep_count = 7
  and store.s_store_name = 'store a'
order by count(*)
limit 100
"""

QUERIES["q98"] = """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(ss_ext_sales_price) itemrevenue,
       sum(ss_ext_sales_price) * 100 /
         sum(sum(ss_ext_sales_price)) over (partition by i_class)
         revenueratio
from store_sales, item, date_dim
where ss_item_sk = i_item_sk
  and i_category in ('Sports', 'Books', 'Home')
  and ss_sold_date_sk = d_date_sk
  and d_year = 1999 and d_moy in (2, 3)
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100
"""

QUERIES["q16"] = """
select count(distinct cs_order_number) order_count,
       sum(cs_ext_list_price) total_shipping_cost,
       sum(cs_net_profit) total_net_profit
from catalog_sales cs1, date_dim, customer_address, call_center
where d_date between date '2002-02-01' and date '2002-04-02'
  and cs1.cs_ship_date_sk = d_date_sk
  and cs1.cs_bill_addr_sk = ca_address_sk
  and ca_state = 'GA'
  and cs1.cs_call_center_sk = cc_call_center_sk
  and exists (select * from catalog_sales cs2
              where cs1.cs_order_number = cs2.cs_order_number
                and cs1.cs_warehouse_sk <> cs2.cs_warehouse_sk)
  and not exists (select * from catalog_returns cr1
                  where cs1.cs_order_number = cr1.cr_order_number)
order by count(distinct cs_order_number)
limit 100
"""

QUERIES["q20"] = """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(cs_ext_sales_price) itemrevenue,
       sum(cs_ext_sales_price) * 100 /
         sum(sum(cs_ext_sales_price)) over (partition by i_class)
         revenueratio
from catalog_sales, item, date_dim
where cs_item_sk = i_item_sk
  and i_category in ('Sports', 'Books', 'Home')
  and cs_sold_date_sk = d_date_sk
  and d_year = 1999 and d_moy in (2, 3)
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100
"""

QUERIES["q25"] = """
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_net_profit) store_sales_profit,
       sum(sr_net_loss) store_returns_loss,
       sum(cs_net_profit) catalog_sales_profit
from store_sales, store_returns, catalog_sales,
     date_dim d1, date_dim d2, date_dim d3, store, item
where d1.d_moy = 4 and d1.d_year = 2000
  and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk
  and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk
  and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_moy between 4 and 10 and d2.d_year = 2000
  and sr_customer_sk = cs_bill_customer_sk
  and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk
  and d3.d_moy between 4 and 10 and d3.d_year = 2000
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100
"""

QUERIES["q32"] = """
select sum(cs_ext_discount_amt) excess_discount_amount
from catalog_sales, item, date_dim
where i_manufact_id = 7
  and i_item_sk = cs_item_sk
  and d_date between date '2000-01-27' and date '2000-04-26'
  and d_date_sk = cs_sold_date_sk
  and cs_ext_discount_amt > (
    select 1.3 * avg(cs_ext_discount_amt)
    from catalog_sales, date_dim
    where cs_item_sk = i_item_sk
      and d_date between date '2000-01-27' and date '2000-04-26'
      and d_date_sk = cs_sold_date_sk)
limit 100
"""

QUERIES["q37"] = """
select i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim, catalog_sales
where i_current_price between 20 and 50
  and inv_item_sk = i_item_sk
  and d_date_sk = inv_date_sk
  and d_date between date '2000-02-01' and date '2000-04-01'
  and i_manufact_id in (1, 2, 3, 4, 5, 6, 7, 8)
  and inv_quantity_on_hand between 100 and 500
  and cs_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id
limit 100
"""

QUERIES["q38"] = """
select count(*) cnt from (
  select distinct c_last_name, c_first_name, d_date
  from store_sales, date_dim, customer
  where store_sales.ss_sold_date_sk = date_dim.d_date_sk
    and store_sales.ss_customer_sk = customer.c_customer_sk
    and d_month_seq between 24 and 35
  intersect
  select distinct c_last_name, c_first_name, d_date
  from catalog_sales, date_dim, customer
  where catalog_sales.cs_sold_date_sk = date_dim.d_date_sk
    and catalog_sales.cs_bill_customer_sk = customer.c_customer_sk
    and d_month_seq between 24 and 35
  intersect
  select distinct c_last_name, c_first_name, d_date
  from web_sales, date_dim, customer
  where web_sales.ws_sold_date_sk = date_dim.d_date_sk
    and web_sales.ws_bill_customer_sk = customer.c_customer_sk
    and d_month_seq between 24 and 35
) hot_cust
limit 100
"""

QUERIES["q45"] = """
select ca_zip, ca_city, sum(ws_sales_price) total
from web_sales, customer, customer_address, date_dim, item
where ws_bill_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and ws_item_sk = i_item_sk
  and (substr(ca_zip, 1, 5) in
         ('85669', '86197', '88274', '83405', '86475',
          '85392', '85460', '80348', '81792')
       or i_item_id in (select i_item_id from item
                        where i_item_sk in (2, 3, 5, 7, 11, 13, 17, 19, 23)))
  and ws_sold_date_sk = d_date_sk
  and d_qoy = 2 and d_year = 2001
group by ca_zip, ca_city
order by ca_zip, ca_city
limit 100
"""

QUERIES["q50"] = """
select s_store_name, s_store_id, s_state,
  sum(case when (sr_returned_date_sk - ss_sold_date_sk <= 30)
           then 1 else 0 end) d30,
  sum(case when (sr_returned_date_sk - ss_sold_date_sk > 30)
            and (sr_returned_date_sk - ss_sold_date_sk <= 60)
           then 1 else 0 end) d60,
  sum(case when (sr_returned_date_sk - ss_sold_date_sk > 60)
            and (sr_returned_date_sk - ss_sold_date_sk <= 90)
           then 1 else 0 end) d90,
  sum(case when (sr_returned_date_sk - ss_sold_date_sk > 90)
           then 1 else 0 end) d120
from store_sales, store_returns, store, date_dim d1, date_dim d2
where d2.d_year = 2001 and d2.d_moy = 8
  and ss_ticket_number = sr_ticket_number
  and ss_item_sk = sr_item_sk
  and ss_sold_date_sk = d1.d_date_sk
  and sr_returned_date_sk = d2.d_date_sk
  and ss_customer_sk = sr_customer_sk
  and ss_store_sk = s_store_sk
group by s_store_name, s_store_id, s_state
order by s_store_name, s_store_id, s_state
limit 100
"""

QUERIES["q61"] = """
select promotions, total, promotions / total * 100 ratio
from (select sum(ss_ext_sales_price) promotions
      from store_sales, store, promotion, date_dim, customer,
           customer_address, item
      where ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and ss_promo_sk = p_promo_sk
        and ss_customer_sk = c_customer_sk
        and ca_address_sk = c_current_addr_sk
        and ss_item_sk = i_item_sk
        and ca_gmt_offset = -5
        and i_category = 'Jewelry'
        and (p_channel_dmail = 'Y' or p_channel_email = 'Y'
             or p_channel_tv = 'Y')
        and s_gmt_offset = -5
        and d_year = 1998 and d_moy = 11) promotional_sales,
     (select sum(ss_ext_sales_price) total
      from store_sales, store, date_dim, customer, customer_address, item
      where ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and ss_customer_sk = c_customer_sk
        and ca_address_sk = c_current_addr_sk
        and ss_item_sk = i_item_sk
        and ca_gmt_offset = -5
        and i_category = 'Jewelry'
        and s_gmt_offset = -5
        and d_year = 1998 and d_moy = 11) all_sales
order by promotions, total
limit 100
"""

QUERIES["q65"] = """
select s_store_name, i_item_desc, sc.revenue, i_current_price, i_brand
from store, item,
     (select ss_store_sk, avg(revenue) as ave
      from (select ss_store_sk, ss_item_sk, sum(ss_sales_price) as revenue
            from store_sales, date_dim
            where ss_sold_date_sk = d_date_sk and d_month_seq between 24 and 35
            group by ss_store_sk, ss_item_sk) sa
      group by ss_store_sk) sb,
     (select ss_store_sk, ss_item_sk, sum(ss_sales_price) as revenue
      from store_sales, date_dim
      where ss_sold_date_sk = d_date_sk and d_month_seq between 24 and 35
      group by ss_store_sk, ss_item_sk) sc
where sb.ss_store_sk = sc.ss_store_sk
  and sc.revenue <= 0.1 * sb.ave
  and s_store_sk = sc.ss_store_sk
  and i_item_sk = sc.ss_item_sk
order by s_store_name, i_item_desc
limit 100
"""

QUERIES["q68"] = """
select c_last_name, c_first_name, ca_city, bought_city, ss_ticket_number,
       extended_price, extended_tax, list_price
from (select ss_ticket_number, ss_customer_sk, ca_city bought_city,
             sum(ss_ext_sales_price) extended_price,
             sum(ss_ext_list_price) list_price,
             sum(ss_ext_tax) extended_tax
      from store_sales, date_dim, store, household_demographics,
           customer_address
      where store_sales.ss_sold_date_sk = date_dim.d_date_sk
        and store_sales.ss_store_sk = store.s_store_sk
        and store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
        and store_sales.ss_addr_sk = customer_address.ca_address_sk
        and date_dim.d_dom between 1 and 2
        and (household_demographics.hd_dep_count = 4
             or household_demographics.hd_vehicle_count = 3)
        and date_dim.d_year in (1999, 2000, 2001)
        and store.s_city in ('Midway', 'Fairview')
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk, ca_city) dn,
     customer, customer_address current_addr
where ss_customer_sk = c_customer_sk
  and customer.c_current_addr_sk = current_addr.ca_address_sk
  and current_addr.ca_city <> bought_city
order by c_last_name, ss_ticket_number
limit 100
"""

QUERIES["q69"] = """
select cd_gender, cd_marital_status, cd_education_status, count(*) cnt1,
       cd_purchase_estimate, count(*) cnt2, cd_credit_rating, count(*) cnt3
from customer c, customer_address ca, customer_demographics
where c.c_current_addr_sk = ca.ca_address_sk
  and ca_state in ('KS', 'GA', 'NY')
  and cd_demo_sk = c.c_current_cdemo_sk
  and exists (select * from store_sales, date_dim
              where c.c_customer_sk = ss_customer_sk
                and ss_sold_date_sk = d_date_sk
                and d_year = 2001 and d_moy between 4 and 6)
  and not exists (select * from web_sales, date_dim
                  where c.c_customer_sk = ws_bill_customer_sk
                    and ws_sold_date_sk = d_date_sk
                    and d_year = 2001 and d_moy between 4 and 6)
  and not exists (select * from catalog_sales, date_dim
                  where c.c_customer_sk = cs_bill_customer_sk
                    and cs_sold_date_sk = d_date_sk
                    and d_year = 2001 and d_moy between 4 and 6)
group by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating
order by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating
limit 100
"""

QUERIES["q79"] = """
select c_last_name, c_first_name, substr(s_city, 1, 30) city30,
       ss_ticket_number, amt, profit
from (select ss_ticket_number, ss_customer_sk, store.s_city,
             sum(ss_coupon_amt) amt, sum(ss_net_profit) profit
      from store_sales, date_dim, store, household_demographics
      where store_sales.ss_sold_date_sk = date_dim.d_date_sk
        and store_sales.ss_store_sk = store.s_store_sk
        and store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
        and (household_demographics.hd_dep_count = 6
             or household_demographics.hd_vehicle_count > 2)
        and date_dim.d_dow = 1
        and date_dim.d_year in (1999, 2000, 2001)
        and store.s_number_employees between 200 and 295
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk, store.s_city) ms,
     customer
where ss_customer_sk = c_customer_sk
order by c_last_name, c_first_name, city30, profit, ss_ticket_number
limit 100
"""

QUERIES["q82"] = """
select i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim, store_sales
where i_current_price between 30 and 60
  and inv_item_sk = i_item_sk
  and d_date_sk = inv_date_sk
  and d_date between date '2000-05-25' and date '2000-07-24'
  and i_manufact_id in (1, 2, 3, 4, 5, 6, 7, 8)
  and inv_quantity_on_hand between 100 and 500
  and ss_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id
limit 100
"""

QUERIES["q87"] = """
select count(*) cnt from (
  (select distinct c_last_name, c_first_name, d_date
   from store_sales, date_dim, customer
   where store_sales.ss_sold_date_sk = date_dim.d_date_sk
     and store_sales.ss_customer_sk = customer.c_customer_sk
     and d_month_seq between 24 and 35)
  except
  (select distinct c_last_name, c_first_name, d_date
   from catalog_sales, date_dim, customer
   where catalog_sales.cs_sold_date_sk = date_dim.d_date_sk
     and catalog_sales.cs_bill_customer_sk = customer.c_customer_sk
     and d_month_seq between 24 and 35)
  except
  (select distinct c_last_name, c_first_name, d_date
   from web_sales, date_dim, customer
   where web_sales.ws_sold_date_sk = date_dim.d_date_sk
     and web_sales.ws_bill_customer_sk = customer.c_customer_sk
     and d_month_seq between 24 and 35)
) cool_cust
"""

QUERIES["q88"] = """
select *
from (select count(*) h8_30_to_9
      from store_sales, household_demographics, time_dim, store
      where ss_sold_time_sk = time_dim.t_time_sk
        and ss_hdemo_sk = household_demographics.hd_demo_sk
        and ss_store_sk = s_store_sk
        and time_dim.t_hour = 8 and time_dim.t_minute >= 30
        and ((household_demographics.hd_dep_count = 4
              and household_demographics.hd_vehicle_count <= 6)
          or (household_demographics.hd_dep_count = 2
              and household_demographics.hd_vehicle_count <= 4)
          or (household_demographics.hd_dep_count = 0
              and household_demographics.hd_vehicle_count <= 2))
        and store.s_store_name = 'store a') s1,
     (select count(*) h9_to_9_30
      from store_sales, household_demographics, time_dim, store
      where ss_sold_time_sk = time_dim.t_time_sk
        and ss_hdemo_sk = household_demographics.hd_demo_sk
        and ss_store_sk = s_store_sk
        and time_dim.t_hour = 9 and time_dim.t_minute < 30
        and ((household_demographics.hd_dep_count = 4
              and household_demographics.hd_vehicle_count <= 6)
          or (household_demographics.hd_dep_count = 2
              and household_demographics.hd_vehicle_count <= 4)
          or (household_demographics.hd_dep_count = 0
              and household_demographics.hd_vehicle_count <= 2))
        and store.s_store_name = 'store a') s2,
     (select count(*) h9_30_to_10
      from store_sales, household_demographics, time_dim, store
      where ss_sold_time_sk = time_dim.t_time_sk
        and ss_hdemo_sk = household_demographics.hd_demo_sk
        and ss_store_sk = s_store_sk
        and time_dim.t_hour = 9 and time_dim.t_minute >= 30
        and ((household_demographics.hd_dep_count = 4
              and household_demographics.hd_vehicle_count <= 6)
          or (household_demographics.hd_dep_count = 2
              and household_demographics.hd_vehicle_count <= 4)
          or (household_demographics.hd_dep_count = 0
              and household_demographics.hd_vehicle_count <= 2))
        and store.s_store_name = 'store a') s3,
     (select count(*) h10_to_10_30
      from store_sales, household_demographics, time_dim, store
      where ss_sold_time_sk = time_dim.t_time_sk
        and ss_hdemo_sk = household_demographics.hd_demo_sk
        and ss_store_sk = s_store_sk
        and time_dim.t_hour = 10 and time_dim.t_minute < 30
        and ((household_demographics.hd_dep_count = 4
              and household_demographics.hd_vehicle_count <= 6)
          or (household_demographics.hd_dep_count = 2
              and household_demographics.hd_vehicle_count <= 4)
          or (household_demographics.hd_dep_count = 0
              and household_demographics.hd_vehicle_count <= 2))
        and store.s_store_name = 'store a') s4
"""

QUERIES["q92"] = """
select sum(ws_ext_discount_amt) excess_discount_amount
from web_sales, item, date_dim
where i_manufact_id = 7
  and i_item_sk = ws_item_sk
  and d_date between date '2000-01-27' and date '2000-04-26'
  and d_date_sk = ws_sold_date_sk
  and ws_ext_discount_amt > (
    select 1.3 * avg(ws_ext_discount_amt)
    from web_sales, date_dim
    where ws_item_sk = i_item_sk
      and d_date between date '2000-01-27' and date '2000-04-26'
      and d_date_sk = ws_sold_date_sk)
order by sum(ws_ext_discount_amt)
limit 100
"""

QUERIES["q94"] = """
select count(distinct ws_order_number) order_count,
       sum(ws_ext_list_price) total_shipping_cost,
       sum(ws_net_profit) total_net_profit
from web_sales ws1, date_dim, customer_address, web_site
where d_date between date '1999-02-01' and date '1999-04-02'
  and ws1.ws_ship_date_sk = d_date_sk
  and ws1.ws_bill_addr_sk = ca_address_sk
  and ca_state = 'IL'
  and ws1.ws_web_site_sk = web_site_sk
  and web_company_name = 'pri0'
  and exists (select * from web_sales ws2
              where ws1.ws_order_number = ws2.ws_order_number
                and ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
  and not exists (select * from web_returns wr1
                  where ws1.ws_order_number = wr1.wr_order_number)
order by count(distinct ws_order_number)
limit 100
"""

QUERIES["q99"] = """
select substr(w_warehouse_name, 1, 20) wname, sm_type, cc_name,
  sum(case when (cs_ship_date_sk - cs_sold_date_sk <= 30)
           then 1 else 0 end) d30,
  sum(case when (cs_ship_date_sk - cs_sold_date_sk > 30)
            and (cs_ship_date_sk - cs_sold_date_sk <= 60)
           then 1 else 0 end) d60,
  sum(case when (cs_ship_date_sk - cs_sold_date_sk > 60)
            and (cs_ship_date_sk - cs_sold_date_sk <= 90)
           then 1 else 0 end) d90,
  sum(case when (cs_ship_date_sk - cs_sold_date_sk > 90)
           then 1 else 0 end) d120
from catalog_sales, warehouse, ship_mode, call_center, date_dim
where d_month_seq between 24 and 35
  and cs_ship_date_sk = d_date_sk
  and cs_warehouse_sk = w_warehouse_sk
  and cs_ship_mode_sk = sm_ship_mode_sk
  and cs_call_center_sk = cc_call_center_sk
group by substr(w_warehouse_name, 1, 20), sm_type, cc_name
order by wname, sm_type, cc_name
limit 100
"""

# --- round-3 expansion: correlated subqueries, EXISTS combos, band ORs ------

QUERIES["q1"] = """
WITH customer_total_return AS (
  SELECT sr_customer_sk AS ctr_customer_sk, sr_store_sk AS ctr_store_sk,
         sum(sr_return_amt) AS ctr_total_return
  FROM store_returns, date_dim
  WHERE sr_returned_date_sk = d_date_sk AND d_year = 2000
  GROUP BY sr_customer_sk, sr_store_sk)
SELECT c_customer_id
FROM customer_total_return ctr1, store, customer
WHERE ctr1.ctr_total_return > (SELECT avg(ctr_total_return) * 1.2
                               FROM customer_total_return ctr2
                               WHERE ctr1.ctr_store_sk = ctr2.ctr_store_sk)
  AND s_store_sk = ctr1.ctr_store_sk
  AND s_state = 'TN'
  AND ctr1.ctr_customer_sk = c_customer_sk
ORDER BY c_customer_id
LIMIT 100
"""

QUERIES["q6"] = """
SELECT a.ca_state AS state, count(*) AS cnt
FROM customer_address a, customer c, store_sales s, date_dim d, item i
WHERE a.ca_address_sk = c.c_current_addr_sk
  AND c.c_customer_sk = s.ss_customer_sk
  AND s.ss_sold_date_sk = d.d_date_sk
  AND s.ss_item_sk = i.i_item_sk
  AND d.d_month_seq = (SELECT DISTINCT d_month_seq FROM date_dim
                       WHERE d_year = 2001 AND d_moy = 1)
  AND i.i_current_price > 1.2 * (SELECT avg(j.i_current_price) FROM item j
                                 WHERE j.i_category = i.i_category)
GROUP BY a.ca_state
HAVING count(*) >= 2
ORDER BY cnt, state
LIMIT 100
"""

QUERIES["q9"] = """
SELECT CASE WHEN (SELECT count(*) FROM store_sales
                  WHERE ss_quantity BETWEEN 1 AND 20) > 5000
            THEN (SELECT avg(ss_ext_discount_amt) FROM store_sales
                  WHERE ss_quantity BETWEEN 1 AND 20)
            ELSE (SELECT avg(ss_net_paid) FROM store_sales
                  WHERE ss_quantity BETWEEN 1 AND 20) END AS bucket1,
       CASE WHEN (SELECT count(*) FROM store_sales
                  WHERE ss_quantity BETWEEN 21 AND 40) > 5000
            THEN (SELECT avg(ss_ext_discount_amt) FROM store_sales
                  WHERE ss_quantity BETWEEN 21 AND 40)
            ELSE (SELECT avg(ss_net_paid) FROM store_sales
                  WHERE ss_quantity BETWEEN 21 AND 40) END AS bucket2,
       CASE WHEN (SELECT count(*) FROM store_sales
                  WHERE ss_quantity BETWEEN 41 AND 60) > 5000
            THEN (SELECT avg(ss_ext_discount_amt) FROM store_sales
                  WHERE ss_quantity BETWEEN 41 AND 60)
            ELSE (SELECT avg(ss_net_paid) FROM store_sales
                  WHERE ss_quantity BETWEEN 41 AND 60) END AS bucket3
FROM reason
WHERE r_reason_sk = 1
"""

QUERIES["q10"] = """
SELECT cd_gender, cd_marital_status, cd_education_status, count(*) AS cnt1,
       cd_purchase_estimate, count(*) AS cnt2
FROM customer c, customer_address ca, customer_demographics
WHERE c.c_current_addr_sk = ca.ca_address_sk
  AND ca_county IN ('Bronx County', 'Barrow County', 'Daviess County')
  AND cd_demo_sk = c.c_current_cdemo_sk
  AND EXISTS (SELECT * FROM store_sales, date_dim
              WHERE c.c_customer_sk = ss_customer_sk
                AND ss_sold_date_sk = d_date_sk AND d_year = 2002
                AND d_moy BETWEEN 1 AND 4)
  AND (EXISTS (SELECT * FROM web_sales, date_dim
               WHERE c.c_customer_sk = ws_bill_customer_sk
                 AND ws_sold_date_sk = d_date_sk AND d_year = 2002
                 AND d_moy BETWEEN 1 AND 4)
       OR EXISTS (SELECT * FROM catalog_sales, date_dim
                  WHERE c.c_customer_sk = cs_bill_customer_sk
                    AND cs_sold_date_sk = d_date_sk AND d_year = 2002
                    AND d_moy BETWEEN 1 AND 4))
GROUP BY cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate
ORDER BY cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate
LIMIT 100
"""

QUERIES["q13"] = """
SELECT avg(ss_quantity) AS a1, avg(ss_ext_sales_price) AS a2,
       avg(ss_ext_wholesale_cost) AS a3, sum(ss_ext_wholesale_cost) AS s1
FROM store_sales, store, customer_demographics, household_demographics,
     customer_address, date_dim
WHERE s_store_sk = ss_store_sk
  AND ss_sold_date_sk = d_date_sk AND d_year = 2001
  AND ss_hdemo_sk = hd_demo_sk AND cd_demo_sk = ss_cdemo_sk
  AND ss_addr_sk = ca_address_sk AND ca_country = 'United States'
  AND ((cd_marital_status = 'M' AND cd_education_status = 'Advanced Degree'
        AND ss_sales_price BETWEEN 50.00 AND 100.00 AND hd_dep_count = 3)
       OR (cd_marital_status = 'S' AND cd_education_status = 'College'
           AND ss_sales_price BETWEEN 10.00 AND 60.00 AND hd_dep_count = 1)
       OR (cd_marital_status = 'W' AND cd_education_status = '2 yr Degree'
           AND ss_sales_price BETWEEN 30.00 AND 80.00 AND hd_dep_count = 1))
  AND ((ca_state IN ('TX', 'OH', 'TN') AND ss_net_profit BETWEEN 0 AND 2000)
       OR (ca_state IN ('AL', 'KS', 'MI') AND ss_net_profit BETWEEN 50 AND 3000)
       OR (ca_state IN ('CA', 'GA', 'NY') AND ss_net_profit BETWEEN 0 AND 25000))
"""

QUERIES["q28"] = """
SELECT b1.lp AS b1_lp, b1.cnt AS b1_cnt, b1.cntd AS b1_cntd,
       b2.lp AS b2_lp, b2.cnt AS b2_cnt, b2.cntd AS b2_cntd,
       b3.lp AS b3_lp, b3.cnt AS b3_cnt, b3.cntd AS b3_cntd
FROM (SELECT avg(ss_list_price) lp, count(ss_list_price) cnt,
             count(DISTINCT ss_list_price) cntd
      FROM store_sales
      WHERE ss_quantity BETWEEN 0 AND 5
        AND (ss_list_price BETWEEN 10 AND 50
             OR ss_coupon_amt BETWEEN 0 AND 200
             OR ss_wholesale_cost BETWEEN 10 AND 30)) b1,
     (SELECT avg(ss_list_price) lp, count(ss_list_price) cnt,
             count(DISTINCT ss_list_price) cntd
      FROM store_sales
      WHERE ss_quantity BETWEEN 6 AND 10
        AND (ss_list_price BETWEEN 20 AND 60
             OR ss_coupon_amt BETWEEN 0 AND 300
             OR ss_wholesale_cost BETWEEN 20 AND 40)) b2,
     (SELECT avg(ss_list_price) lp, count(ss_list_price) cnt,
             count(DISTINCT ss_list_price) cntd
      FROM store_sales
      WHERE ss_quantity BETWEEN 11 AND 15
        AND (ss_list_price BETWEEN 30 AND 70
             OR ss_coupon_amt BETWEEN 0 AND 400
             OR ss_wholesale_cost BETWEEN 30 AND 50)) b3
"""

QUERIES["q29"] = """
SELECT i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_quantity) AS store_sales_quantity,
       sum(sr_return_quantity) AS store_returns_quantity,
       sum(cs_quantity) AS catalog_sales_quantity
FROM store_sales, store_returns, catalog_sales, date_dim d1, date_dim d2,
     date_dim d3, store, item
WHERE d1.d_year = 1999
  AND d1.d_date_sk = ss_sold_date_sk
  AND i_item_sk = ss_item_sk AND s_store_sk = ss_store_sk
  AND ss_customer_sk = sr_customer_sk AND ss_item_sk = sr_item_sk
  AND ss_ticket_number = sr_ticket_number
  AND sr_returned_date_sk = d2.d_date_sk
  AND d2.d_year = 1999
  AND sr_customer_sk = cs_bill_customer_sk AND sr_item_sk = cs_item_sk
  AND cs_sold_date_sk = d3.d_date_sk
  AND d3.d_year IN (1999, 2000, 2001)
GROUP BY i_item_id, i_item_desc, s_store_id, s_store_name
ORDER BY i_item_id, i_item_desc, s_store_id
LIMIT 100
"""

QUERIES["q34"] = """
SELECT c_last_name, c_first_name, c_customer_id, cnt
FROM (SELECT ss_customer_sk, count(*) AS cnt
      FROM store_sales, store, household_demographics
      WHERE ss_store_sk = s_store_sk
        AND ss_hdemo_sk = hd_demo_sk
        AND (hd_buy_potential = '>10000' OR hd_buy_potential = 'Unknown')
        AND hd_vehicle_count > 0
        AND s_county IN ('Richland County', 'Daviess County',
                         'Maverick County')
      GROUP BY ss_customer_sk) dn, customer
WHERE ss_customer_sk = c_customer_sk AND cnt BETWEEN 5 AND 10
ORDER BY c_last_name, c_first_name, c_customer_id
LIMIT 1000
"""

QUERIES["q41"] = """
SELECT DISTINCT i_product_name
FROM item i1
WHERE i_manufact_id BETWEEN 5 AND 15
  AND (SELECT count(*) FROM item
       WHERE i_manufact = i1.i_manufact
         AND ((i_category = 'Women' AND i_color IN ('plum', 'pink'))
              OR (i_category = 'Men' AND i_color IN ('black', 'blue'))
              OR (i_category = 'Shoes'
                  AND i_color IN ('green', 'ivory')))) > 0
ORDER BY i_product_name
LIMIT 100
"""

QUERIES["q48"] = """
SELECT sum(ss_quantity) AS total
FROM store_sales, store, customer_demographics, customer_address, date_dim
WHERE s_store_sk = ss_store_sk
  AND ss_sold_date_sk = d_date_sk AND d_year = 2000
  AND cd_demo_sk = ss_cdemo_sk
  AND ss_addr_sk = ca_address_sk AND ca_country = 'United States'
  AND ((cd_marital_status = 'M' AND cd_education_status = '4 yr Degree'
        AND ss_sales_price BETWEEN 100.00 AND 150.00)
       OR (cd_marital_status = 'D' AND cd_education_status = '2 yr Degree'
           AND ss_sales_price BETWEEN 50.00 AND 100.00)
       OR (cd_marital_status = 'S' AND cd_education_status = 'College'
           AND ss_sales_price BETWEEN 150.00 AND 200.00))
  AND ((ca_state IN ('CO', 'OH', 'TX') AND ss_net_profit BETWEEN 0 AND 2000)
       OR (ca_state IN ('OR', 'MN', 'KS') AND ss_net_profit BETWEEN 150 AND 3000)
       OR (ca_state IN ('TX', 'MO', 'MI') AND ss_net_profit BETWEEN 50 AND 25000))
"""

QUERIES["q17"] = """
SELECT i_item_id, i_item_desc, s_state,
       count(ss_quantity) AS store_sales_quantitycount,
       avg(ss_quantity) AS store_sales_quantityave,
       stddev_samp(ss_quantity) AS store_sales_quantitystdev,
       count(sr_return_quantity) AS store_returns_quantitycount,
       avg(sr_return_quantity) AS store_returns_quantityave,
       count(cs_quantity) AS catalog_sales_quantitycount,
       avg(cs_quantity) AS catalog_sales_quantityave
FROM store_sales, store_returns, catalog_sales, date_dim d1, date_dim d2,
     date_dim d3, store, item
WHERE d1.d_qoy = 1 AND d1.d_year = 1999 AND d1.d_date_sk = ss_sold_date_sk
  AND i_item_sk = ss_item_sk AND s_store_sk = ss_store_sk
  AND ss_customer_sk = sr_customer_sk AND ss_item_sk = sr_item_sk
  AND ss_ticket_number = sr_ticket_number
  AND sr_returned_date_sk = d2.d_date_sk
  AND d2.d_year = 1999
  AND sr_customer_sk = cs_bill_customer_sk AND sr_item_sk = cs_item_sk
  AND cs_sold_date_sk = d3.d_date_sk
GROUP BY i_item_id, i_item_desc, s_state
ORDER BY i_item_id, i_item_desc, s_state
LIMIT 100
"""

QUERIES["q18"] = """
SELECT i_item_id, ca_state,
       avg(cs_quantity) AS agg1, avg(cs_list_price) AS agg2,
       avg(cs_coupon_amt) AS agg3, avg(cs_sales_price) AS agg4
FROM catalog_sales, customer_demographics cd1, customer, customer_address,
     date_dim, item
WHERE cs_sold_date_sk = d_date_sk AND cs_item_sk = i_item_sk
  AND cs_bill_cdemo_sk = cd1.cd_demo_sk
  AND cs_bill_customer_sk = c_customer_sk
  AND cd1.cd_gender = 'F' AND cd1.cd_education_status = 'Unknown'
  AND c_current_addr_sk = ca_address_sk
  AND d_year = 1998
  AND c_birth_month IN (1, 6, 8, 9, 12, 2)
GROUP BY ROLLUP (i_item_id, ca_state)
ORDER BY ca_state, i_item_id
LIMIT 1000
"""

QUERIES["q30"] = """
WITH customer_total_return AS (
  SELECT wr_returning_cdemo_sk AS ctr_cdemo_sk,
         ca_state AS ctr_state,
         sum(wr_return_amt) AS ctr_total_return
  FROM web_returns, date_dim, customer_address
  WHERE wr_returned_date_sk = d_date_sk AND d_year = 2000
    AND wr_refunded_addr_sk = ca_address_sk
  GROUP BY wr_returning_cdemo_sk, ca_state)
SELECT ctr_cdemo_sk, ctr_state, ctr_total_return
FROM customer_total_return ctr1
WHERE ctr1.ctr_total_return > (SELECT avg(ctr_total_return) * 1.2
                               FROM customer_total_return ctr2
                               WHERE ctr1.ctr_state = ctr2.ctr_state)
ORDER BY ctr_cdemo_sk, ctr_state, ctr_total_return
LIMIT 100
"""

QUERIES["q31"] = """
WITH ss AS (
  SELECT ca_county, d_qoy, d_year, sum(ss_ext_sales_price) AS store_sales
  FROM store_sales, date_dim, customer_address
  WHERE ss_sold_date_sk = d_date_sk AND ss_addr_sk = ca_address_sk
  GROUP BY ca_county, d_qoy, d_year),
ws AS (
  SELECT ca_county, d_qoy, d_year, sum(ws_ext_sales_price) AS web_sales
  FROM web_sales, date_dim, customer_address
  WHERE ws_sold_date_sk = d_date_sk AND ws_bill_addr_sk = ca_address_sk
  GROUP BY ca_county, d_qoy, d_year)
SELECT ss1.ca_county, ss1.d_year,
       ws2.web_sales / ws1.web_sales AS web_q1_q2_increase,
       ss2.store_sales / ss1.store_sales AS store_q1_q2_increase
FROM ss ss1, ss ss2, ws ws1, ws ws2
WHERE ss1.d_qoy = 1 AND ss1.d_year = 2000
  AND ss2.d_qoy = 2 AND ss2.d_year = 2000
  AND ss1.ca_county = ss2.ca_county
  AND ws1.d_qoy = 1 AND ws1.d_year = 2000
  AND ws2.d_qoy = 2 AND ws2.d_year = 2000
  AND ws1.ca_county = ws2.ca_county
  AND ss1.ca_county = ws1.ca_county
  AND ws2.web_sales / ws1.web_sales > ss2.store_sales / ss1.store_sales
ORDER BY ss1.ca_county
LIMIT 100
"""

QUERIES["q33"] = """
WITH ss AS (
  SELECT i_manufact_id, sum(ss_ext_sales_price) AS total_sales
  FROM store_sales, date_dim, customer_address, item
  WHERE i_manufact_id IN (SELECT i_manufact_id FROM item
                          WHERE i_category = 'Electronics')
    AND ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
    AND d_year = 1998 AND d_moy = 5
    AND ss_addr_sk = ca_address_sk AND ca_gmt_offset = -5
  GROUP BY i_manufact_id),
cs AS (
  SELECT i_manufact_id, sum(cs_ext_sales_price) AS total_sales
  FROM catalog_sales, date_dim, customer_address, item
  WHERE i_manufact_id IN (SELECT i_manufact_id FROM item
                          WHERE i_category = 'Electronics')
    AND cs_item_sk = i_item_sk AND cs_sold_date_sk = d_date_sk
    AND d_year = 1998 AND d_moy = 5
    AND cs_bill_addr_sk = ca_address_sk AND ca_gmt_offset = -5
  GROUP BY i_manufact_id),
ws AS (
  SELECT i_manufact_id, sum(ws_ext_sales_price) AS total_sales
  FROM web_sales, date_dim, customer_address, item
  WHERE i_manufact_id IN (SELECT i_manufact_id FROM item
                          WHERE i_category = 'Electronics')
    AND ws_item_sk = i_item_sk AND ws_sold_date_sk = d_date_sk
    AND d_year = 1998 AND d_moy = 5
    AND ws_bill_addr_sk = ca_address_sk AND ca_gmt_offset = -5
  GROUP BY i_manufact_id)
SELECT i_manufact_id, sum(total_sales) AS total_sales
FROM (SELECT * FROM ss UNION ALL SELECT * FROM cs
      UNION ALL SELECT * FROM ws) tmp1
GROUP BY i_manufact_id
ORDER BY total_sales, i_manufact_id
LIMIT 100
"""

QUERIES["q40"] = """
SELECT w_state, i_item_id,
       sum(CASE WHEN d_date < DATE '2000-03-11'
                THEN cs_sales_price ELSE 0 END) AS sales_before,
       sum(CASE WHEN d_date >= DATE '2000-03-11'
                THEN cs_sales_price ELSE 0 END) AS sales_after
FROM catalog_sales
LEFT OUTER JOIN catalog_returns
  ON cs_order_number = cr_order_number AND cs_item_sk = cr_item_sk,
warehouse, item, date_dim
WHERE i_current_price BETWEEN 10 AND 90
  AND i_item_sk = cs_item_sk
  AND cs_warehouse_sk = w_warehouse_sk
  AND cs_sold_date_sk = d_date_sk
  AND d_date BETWEEN DATE '2000-02-10' AND DATE '2000-04-10'
GROUP BY w_state, i_item_id
ORDER BY w_state, i_item_id
LIMIT 100
"""

QUERIES["q44"] = """
WITH v AS (SELECT ss_item_sk item_sk, avg(ss_net_profit) rank_col
           FROM store_sales WHERE ss_store_sk = 2 GROUP BY ss_item_sk)
SELECT asceding.rnk AS rnk, i1.i_product_name AS best_performing,
       i2.i_product_name AS worst_performing
FROM (SELECT item_sk, rank() OVER (ORDER BY rank_col ASC) rnk
      FROM v) asceding,
     (SELECT item_sk, rank() OVER (ORDER BY rank_col DESC) rnk
      FROM v) descending,
     item i1, item i2
WHERE asceding.rnk = descending.rnk AND asceding.rnk < 11
  AND i1.i_item_sk = asceding.item_sk
  AND i2.i_item_sk = descending.item_sk
ORDER BY asceding.rnk
LIMIT 100
"""

QUERIES["q46"] = """
SELECT c_last_name, c_first_name, ca_city, bought_city, amt, profit
FROM (SELECT ss_customer_sk, ca_city AS bought_city,
             sum(ss_coupon_amt) AS amt, sum(ss_net_profit) AS profit
      FROM store_sales, date_dim, store, household_demographics,
           customer_address
      WHERE ss_sold_date_sk = d_date_sk AND ss_store_sk = s_store_sk
        AND ss_hdemo_sk = hd_demo_sk AND ss_addr_sk = ca_address_sk
        AND (hd_dep_count = 4 OR hd_vehicle_count = 3)
        AND d_dow IN (6, 0)
        AND d_year IN (1999, 2000, 2001)
      GROUP BY ss_customer_sk, ss_addr_sk, ca_city) dn,
     customer, customer_address current_addr
WHERE ss_customer_sk = c_customer_sk
  AND customer.c_current_addr_sk = current_addr.ca_address_sk
  AND current_addr.ca_city <> bought_city
ORDER BY c_last_name, c_first_name, ca_city, bought_city, amt, profit
LIMIT 1000
"""

QUERIES["q47"] = """
WITH v1 AS (
  SELECT i_category, i_brand, s_store_name, d_year, d_moy,
         sum(ss_sales_price) AS sum_sales,
         avg(sum(ss_sales_price)) OVER (PARTITION BY i_category, i_brand,
                                        s_store_name, d_year)
           AS avg_monthly_sales,
         rank() OVER (PARTITION BY i_category, i_brand, s_store_name
                      ORDER BY d_year, d_moy) AS rn
  FROM item, store_sales, date_dim, store
  WHERE ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
    AND ss_store_sk = s_store_sk
    AND (d_year = 1999 OR (d_year = 1998 AND d_moy = 12)
         OR (d_year = 2000 AND d_moy = 1))
  GROUP BY i_category, i_brand, s_store_name, d_year, d_moy)
SELECT v1.i_category, v1.i_brand, v1.s_store_name, v1.d_year, v1.d_moy,
       v1.avg_monthly_sales, v1.sum_sales,
       v1_lag.sum_sales AS psum, v1_lead.sum_sales AS nsum
FROM v1, v1 v1_lag, v1 v1_lead
WHERE v1.i_category = v1_lag.i_category
  AND v1.i_category = v1_lead.i_category
  AND v1.i_brand = v1_lag.i_brand AND v1.i_brand = v1_lead.i_brand
  AND v1.s_store_name = v1_lag.s_store_name
  AND v1.s_store_name = v1_lead.s_store_name
  AND v1.rn = v1_lag.rn + 1 AND v1.rn = v1_lead.rn - 1
  AND v1.d_year = 1999
  AND v1.avg_monthly_sales > 0
  AND abs(v1.sum_sales - v1.avg_monthly_sales) / v1.avg_monthly_sales > 0.1
ORDER BY v1.i_category, v1.i_brand, v1.s_store_name, v1.d_moy
LIMIT 100
"""

QUERIES["q51"] = """
WITH web_v1 AS (
  SELECT ws_item_sk item_sk, d_date,
         sum(sum(ws_sales_price)) OVER (PARTITION BY ws_item_sk
                                        ORDER BY d_date
                                        ROWS BETWEEN UNBOUNDED PRECEDING
                                        AND CURRENT ROW) cume_sales
  FROM web_sales, date_dim
  WHERE ws_sold_date_sk = d_date_sk AND d_month_seq BETWEEN 24 AND 35
  GROUP BY ws_item_sk, d_date),
store_v1 AS (
  SELECT ss_item_sk item_sk, d_date,
         sum(sum(ss_sales_price)) OVER (PARTITION BY ss_item_sk
                                        ORDER BY d_date
                                        ROWS BETWEEN UNBOUNDED PRECEDING
                                        AND CURRENT ROW) cume_sales
  FROM store_sales, date_dim
  WHERE ss_sold_date_sk = d_date_sk AND d_month_seq BETWEEN 24 AND 35
  GROUP BY ss_item_sk, d_date)
SELECT item_sk, d_date, web_sales, store_sales
FROM (SELECT CASE WHEN web.item_sk IS NOT NULL THEN web.item_sk
                  ELSE store.item_sk END item_sk,
             CASE WHEN web.d_date IS NOT NULL THEN web.d_date
                  ELSE store.d_date END d_date,
             web.cume_sales web_sales, store.cume_sales store_sales
      FROM web_v1 web FULL OUTER JOIN store_v1 store
        ON web.item_sk = store.item_sk AND web.d_date = store.d_date) x
WHERE web_sales > store_sales
ORDER BY item_sk, d_date
LIMIT 100
"""

QUERIES["q35"] = """
SELECT ca_state, cd_gender, cd_marital_status, cd_dep_count,
       count(*) AS cnt1, avg(cd_dep_count) AS a1, max(cd_dep_count) AS m1,
       sum(cd_dep_count) AS s1
FROM customer c, customer_address ca, customer_demographics
WHERE c.c_current_addr_sk = ca.ca_address_sk
  AND cd_demo_sk = c.c_current_cdemo_sk
  AND EXISTS (SELECT * FROM store_sales, date_dim
              WHERE c.c_customer_sk = ss_customer_sk
                AND ss_sold_date_sk = d_date_sk AND d_year = 2002
                AND d_qoy < 4)
  AND (EXISTS (SELECT * FROM web_sales, date_dim
               WHERE c.c_customer_sk = ws_bill_customer_sk
                 AND ws_sold_date_sk = d_date_sk AND d_year = 2002
                 AND d_qoy < 4)
       OR EXISTS (SELECT * FROM catalog_sales, date_dim
                  WHERE c.c_customer_sk = cs_bill_customer_sk
                    AND cs_sold_date_sk = d_date_sk AND d_year = 2002
                    AND d_qoy < 4))
GROUP BY ca_state, cd_gender, cd_marital_status, cd_dep_count
ORDER BY ca_state, cd_gender, cd_marital_status, cd_dep_count
LIMIT 100
"""

QUERIES["q39"] = """
WITH inv AS (
  SELECT w_warehouse_sk, i_item_sk, d_moy, stddev_samp(inv_quantity_on_hand) stdev,
         avg(inv_quantity_on_hand) mean
  FROM inventory, item, warehouse, date_dim
  WHERE inv_item_sk = i_item_sk AND inv_warehouse_sk = w_warehouse_sk
    AND inv_date_sk = d_date_sk AND d_year = 1999
  GROUP BY w_warehouse_sk, i_item_sk, d_moy)
SELECT inv1.w_warehouse_sk, inv1.i_item_sk, inv1.d_moy, inv1.mean,
       inv1.stdev / inv1.mean AS cov1,
       inv2.d_moy AS d_moy_2, inv2.mean AS mean2,
       inv2.stdev / inv2.mean AS cov2
FROM inv inv1, inv inv2
WHERE inv1.i_item_sk = inv2.i_item_sk
  AND inv1.w_warehouse_sk = inv2.w_warehouse_sk
  AND inv1.d_moy = 1 AND inv2.d_moy = 2
  AND inv1.mean > 0 AND inv2.mean > 0
  AND inv1.stdev / inv1.mean > 0.5
ORDER BY inv1.w_warehouse_sk, inv1.i_item_sk
LIMIT 200
"""

QUERIES["q58"] = """
WITH ss_items AS (
  SELECT i_item_id item_id, sum(ss_ext_sales_price) ss_item_rev
  FROM store_sales, item, date_dim
  WHERE ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
    AND d_month_seq = (SELECT d_month_seq FROM date_dim
                       WHERE d_date = DATE '2000-03-11')
  GROUP BY i_item_id),
cs_items AS (
  SELECT i_item_id item_id, sum(cs_ext_sales_price) cs_item_rev
  FROM catalog_sales, item, date_dim
  WHERE cs_item_sk = i_item_sk AND cs_sold_date_sk = d_date_sk
    AND d_month_seq = (SELECT d_month_seq FROM date_dim
                       WHERE d_date = DATE '2000-03-11')
  GROUP BY i_item_id),
ws_items AS (
  SELECT i_item_id item_id, sum(ws_ext_sales_price) ws_item_rev
  FROM web_sales, item, date_dim
  WHERE ws_item_sk = i_item_sk AND ws_sold_date_sk = d_date_sk
    AND d_month_seq = (SELECT d_month_seq FROM date_dim
                       WHERE d_date = DATE '2000-03-11')
  GROUP BY i_item_id)
SELECT ss_items.item_id, ss_item_rev, cs_item_rev, ws_item_rev
FROM ss_items, cs_items, ws_items
WHERE ss_items.item_id = cs_items.item_id
  AND ss_items.item_id = ws_items.item_id
  AND ss_item_rev BETWEEN 0.5 * cs_item_rev AND 2.0 * cs_item_rev
  AND ss_item_rev BETWEEN 0.5 * ws_item_rev AND 2.0 * ws_item_rev
ORDER BY ss_items.item_id
LIMIT 100
"""

QUERIES["q59"] = """
WITH wss AS (
  SELECT d_week_seq, ss_store_sk,
         sum(CASE WHEN d_day_name = 'Sunday' THEN ss_sales_price
                  ELSE 0 END) sun_sales,
         sum(CASE WHEN d_day_name = 'Monday' THEN ss_sales_price
                  ELSE 0 END) mon_sales,
         sum(CASE WHEN d_day_name = 'Friday' THEN ss_sales_price
                  ELSE 0 END) fri_sales
  FROM store_sales, date_dim
  WHERE d_date_sk = ss_sold_date_sk
  GROUP BY d_week_seq, ss_store_sk)
SELECT s_store_name, y.d_week_seq AS week1,
       y.sun_sales / x.sun_sales AS r_sun,
       y.mon_sales / x.mon_sales AS r_mon,
       y.fri_sales / x.fri_sales AS r_fri
FROM wss y, wss x, store
WHERE y.ss_store_sk = x.ss_store_sk
  AND y.ss_store_sk = s_store_sk
  AND y.d_week_seq = x.d_week_seq - 52
  AND y.d_week_seq BETWEEN 52 AND 103
  AND x.sun_sales > 0 AND x.mon_sales > 0 AND x.fri_sales > 0
ORDER BY s_store_name, week1
LIMIT 200
"""

QUERIES["q60"] = """
WITH ss AS (
  SELECT i_item_id, sum(ss_ext_sales_price) AS total_sales
  FROM store_sales, date_dim, customer_address, item
  WHERE i_item_id IN (SELECT i_item_id FROM item
                      WHERE i_category = 'Children')
    AND ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
    AND d_year = 1999 AND d_moy = 9
    AND ss_addr_sk = ca_address_sk AND ca_gmt_offset = -5
  GROUP BY i_item_id),
cs AS (
  SELECT i_item_id, sum(cs_ext_sales_price) AS total_sales
  FROM catalog_sales, date_dim, customer_address, item
  WHERE i_item_id IN (SELECT i_item_id FROM item
                      WHERE i_category = 'Children')
    AND cs_item_sk = i_item_sk AND cs_sold_date_sk = d_date_sk
    AND d_year = 1999 AND d_moy = 9
    AND cs_bill_addr_sk = ca_address_sk AND ca_gmt_offset = -5
  GROUP BY i_item_id),
ws AS (
  SELECT i_item_id, sum(ws_ext_sales_price) AS total_sales
  FROM web_sales, date_dim, customer_address, item
  WHERE i_item_id IN (SELECT i_item_id FROM item
                      WHERE i_category = 'Children')
    AND ws_item_sk = i_item_sk AND ws_sold_date_sk = d_date_sk
    AND d_year = 1999 AND d_moy = 9
    AND ws_bill_addr_sk = ca_address_sk AND ca_gmt_offset = -5
  GROUP BY i_item_id)
SELECT i_item_id, sum(total_sales) AS total_sales
FROM (SELECT * FROM ss UNION ALL SELECT * FROM cs
      UNION ALL SELECT * FROM ws) tmp1
GROUP BY i_item_id
ORDER BY i_item_id, total_sales
LIMIT 100
"""

QUERIES["q63"] = """
SELECT mgr, sum_sales, avg_monthly
FROM (SELECT i_manager_id AS mgr, sum(ss_sales_price) AS sum_sales,
             avg(sum(ss_sales_price)) OVER (PARTITION BY i_manager_id)
               AS avg_monthly
      FROM item, store_sales, date_dim, store
      WHERE ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
        AND ss_store_sk = s_store_sk
        AND d_year = 1999
        AND ((i_category IN ('Books', 'Children', 'Electronics')
              AND i_class IN ('class01', 'class02', 'class03', 'class04'))
             OR (i_category IN ('Women', 'Music', 'Men')
                 AND i_class IN ('class05', 'class06', 'class07',
                                 'class08')))
      GROUP BY i_manager_id, d_moy) tmp1
WHERE CASE WHEN avg_monthly > 0
           THEN abs(sum_sales - avg_monthly) / avg_monthly
           ELSE NULL END > 0.0001
ORDER BY mgr, sum_sales
LIMIT 100
"""

QUERIES["q66"] = """
SELECT w_warehouse_name, w_warehouse_sq_ft, ship_carriers, d_year,
       sum(jan_sales) AS jan_sales, sum(feb_sales) AS feb_sales,
       sum(mar_sales) AS mar_sales
FROM (SELECT w_warehouse_name, w_warehouse_sq_ft,
             'DHL,BARIAN' AS ship_carriers, d_year,
             sum(CASE WHEN d_moy = 1 THEN ws_ext_sales_price * ws_quantity
                      ELSE 0 END) AS jan_sales,
             sum(CASE WHEN d_moy = 2 THEN ws_ext_sales_price * ws_quantity
                      ELSE 0 END) AS feb_sales,
             sum(CASE WHEN d_moy = 3 THEN ws_ext_sales_price * ws_quantity
                      ELSE 0 END) AS mar_sales
      FROM web_sales, warehouse, date_dim, time_dim, ship_mode
      WHERE ws_warehouse_sk = w_warehouse_sk
        AND ws_sold_date_sk = d_date_sk AND d_year = 1999
        AND ws_sold_time_sk = t_time_sk
        AND t_hour BETWEEN 8 AND 17
        AND ws_ship_mode_sk = sm_ship_mode_sk
        AND sm_carrier IN ('DHL', 'BARIAN', 'UPS', 'FEDEX', 'AIRBORNE',
                           'USPS', 'TBS', 'ZOUROS', 'MSC', 'LATVIAN')
      GROUP BY w_warehouse_name, w_warehouse_sq_ft, d_year
      UNION ALL
      SELECT w_warehouse_name, w_warehouse_sq_ft,
             'DHL,BARIAN' AS ship_carriers, d_year,
             sum(CASE WHEN d_moy = 1 THEN cs_ext_sales_price * cs_quantity
                      ELSE 0 END) AS jan_sales,
             sum(CASE WHEN d_moy = 2 THEN cs_ext_sales_price * cs_quantity
                      ELSE 0 END) AS feb_sales,
             sum(CASE WHEN d_moy = 3 THEN cs_ext_sales_price * cs_quantity
                      ELSE 0 END) AS mar_sales
      FROM catalog_sales, warehouse, date_dim, ship_mode
      WHERE cs_warehouse_sk = w_warehouse_sk
        AND cs_sold_date_sk = d_date_sk AND d_year = 1999
        AND cs_ship_mode_sk = sm_ship_mode_sk
        AND sm_carrier IN ('DHL', 'BARIAN', 'UPS', 'FEDEX', 'AIRBORNE',
                           'USPS', 'TBS', 'ZOUROS', 'MSC', 'LATVIAN')
      GROUP BY w_warehouse_name, w_warehouse_sq_ft, d_year) x
GROUP BY w_warehouse_name, w_warehouse_sq_ft, ship_carriers, d_year
ORDER BY w_warehouse_name
LIMIT 100
"""

QUERIES["q71"] = """
SELECT i_brand_id AS brand_id, i_brand AS brand, t_hour, t_minute,
       sum(ext_price) AS ext_price
FROM item,
     (SELECT ws_ext_sales_price AS ext_price,
             ws_sold_date_sk AS sold_date_sk, ws_item_sk AS sold_item_sk,
             ws_sold_time_sk AS time_sk
      FROM web_sales, date_dim
      WHERE d_date_sk = ws_sold_date_sk AND d_moy = 11 AND d_year = 1999
      UNION ALL
      SELECT ss_ext_sales_price AS ext_price,
             ss_sold_date_sk AS sold_date_sk, ss_item_sk AS sold_item_sk,
             ss_sold_time_sk AS time_sk
      FROM store_sales, date_dim
      WHERE d_date_sk = ss_sold_date_sk AND d_moy = 11 AND d_year = 1999
     ) tmp, time_dim
WHERE sold_item_sk = i_item_sk AND i_manager_id = 1
  AND time_sk = t_time_sk
  AND (t_hour BETWEEN 7 AND 9 OR t_hour BETWEEN 19 AND 21)
GROUP BY i_brand, i_brand_id, t_hour, t_minute
ORDER BY ext_price DESC, i_brand_id, t_hour, t_minute
LIMIT 200
"""

QUERIES["q73"] = """
SELECT c_last_name, c_first_name, c_customer_id, cnt
FROM (SELECT ss_customer_sk, count(*) AS cnt
      FROM store_sales, store, household_demographics
      WHERE ss_store_sk = s_store_sk
        AND ss_hdemo_sk = hd_demo_sk
        AND hd_buy_potential IN ('501-1000', '5001-10000')
        AND hd_vehicle_count > 0
        AND CASE WHEN hd_vehicle_count > 0
                 THEN hd_dep_count / hd_vehicle_count ELSE NULL END > 0
      GROUP BY ss_customer_sk) dj, customer
WHERE ss_customer_sk = c_customer_sk AND cnt BETWEEN 3 AND 8
ORDER BY c_last_name, c_first_name, c_customer_id
LIMIT 1000
"""

QUERIES["q76"] = """
SELECT channel, col_name, d_year, d_qoy, i_category, count(*) AS sales_cnt,
       sum(ext_sales_price) AS sales_amt
FROM (SELECT 'store' AS channel, 'ss_promo_sk' AS col_name, d_year, d_qoy,
             i_category, ss_ext_sales_price AS ext_sales_price
      FROM store_sales, item, date_dim
      WHERE ss_promo_sk IS NULL AND ss_sold_date_sk = d_date_sk
        AND ss_item_sk = i_item_sk
      UNION ALL
      SELECT 'web' AS channel, 'ws_promo_sk' AS col_name, d_year, d_qoy,
             i_category, ws_ext_sales_price AS ext_sales_price
      FROM web_sales, item, date_dim
      WHERE ws_promo_sk IS NULL AND ws_sold_date_sk = d_date_sk
        AND ws_item_sk = i_item_sk
      UNION ALL
      SELECT 'catalog' AS channel, 'cs_promo_sk' AS col_name, d_year, d_qoy,
             i_category, cs_ext_sales_price AS ext_sales_price
      FROM catalog_sales, item, date_dim
      WHERE cs_promo_sk IS NULL AND cs_sold_date_sk = d_date_sk
        AND cs_item_sk = i_item_sk) foo
GROUP BY channel, col_name, d_year, d_qoy, i_category
ORDER BY channel, col_name, d_year, d_qoy, i_category
LIMIT 500
"""

QUERIES["q84"] = """
SELECT c_customer_id AS customer_id, c_last_name AS customername
FROM customer, customer_address, customer_demographics,
     household_demographics, income_band
WHERE ca_city = 'Riverside'
  AND c_current_addr_sk = ca_address_sk
  AND ib_lower_bound >= 10000
  AND ib_upper_bound <= 200000
  AND ib_income_band_sk = hd_income_band_sk
  AND hd_demo_sk = c_current_hdemo_sk
  AND cd_demo_sk = c_current_cdemo_sk
ORDER BY c_customer_id
LIMIT 100
"""

QUERIES["q85"] = """
SELECT r_reason_desc, avg(ws_quantity) AS a1, avg(wr_return_amt) AS a2,
       avg(wr_fee) AS a3
FROM web_sales, web_returns, web_page, customer_demographics cd1, reason
WHERE ws_web_page_sk = wp_web_page_sk
  AND ws_item_sk = wr_item_sk AND ws_order_number = wr_order_number
  AND wr_refunded_cdemo_sk = cd1.cd_demo_sk
  AND wr_reason_sk = r_reason_sk
  AND ((cd1.cd_marital_status = 'M'
        AND cd1.cd_education_status = 'Advanced Degree'
        AND ws_sales_price BETWEEN 50.00 AND 150.00)
       OR (cd1.cd_marital_status = 'S'
           AND cd1.cd_education_status = 'College'
           AND ws_sales_price BETWEEN 10.00 AND 100.00)
       OR (cd1.cd_marital_status = 'W'
           AND cd1.cd_education_status = '2 yr Degree'
           AND ws_sales_price BETWEEN 50.00 AND 200.00))
GROUP BY r_reason_desc
ORDER BY r_reason_desc
LIMIT 100
"""

QUERIES["q90"] = """
SELECT CAST(amc AS DOUBLE) / CAST(pmc AS DOUBLE) AS am_pm_ratio
FROM (SELECT count(*) AS amc FROM web_sales, time_dim, web_page
      WHERE ws_sold_time_sk = t_time_sk
        AND ws_web_page_sk = wp_web_page_sk
        AND t_hour BETWEEN 8 AND 9
        AND wp_char_count BETWEEN 2500 AND 5200) at1,
     (SELECT count(*) AS pmc FROM web_sales, time_dim, web_page
      WHERE ws_sold_time_sk = t_time_sk
        AND ws_web_page_sk = wp_web_page_sk
        AND t_hour BETWEEN 19 AND 20
        AND wp_char_count BETWEEN 2500 AND 5200) pt
"""

QUERIES["q91"] = """
SELECT cc_call_center_id AS call_center, cc_name, sum(cr_net_loss) AS returns_loss
FROM call_center, catalog_returns, date_dim, customer,
     customer_demographics, household_demographics
WHERE cr_call_center_sk = cc_call_center_sk
  AND cr_returned_date_sk = d_date_sk
  AND cr_returning_customer_sk = c_customer_sk
  AND cd_demo_sk = c_current_cdemo_sk
  AND hd_demo_sk = c_current_hdemo_sk
  AND d_year = 1999
  AND ((cd_marital_status = 'M' AND cd_education_status = 'Unknown')
       OR (cd_marital_status = 'W'
           AND cd_education_status = 'Advanced Degree'))
  AND hd_buy_potential LIKE 'Unknown%'
GROUP BY cc_call_center_id, cc_name
ORDER BY cc_call_center_id
LIMIT 100
"""

QUERIES["q93"] = """
SELECT ss_customer_sk, sum(act_sales) AS sumsales
FROM (SELECT ss_customer_sk,
             CASE WHEN sr_return_quantity IS NOT NULL
                  THEN (ss_quantity - sr_return_quantity) * ss_sales_price
                  ELSE ss_quantity * ss_sales_price END AS act_sales
      FROM store_sales
      LEFT OUTER JOIN store_returns
        ON sr_item_sk = ss_item_sk AND sr_ticket_number = ss_ticket_number,
      reason
      WHERE sr_reason_sk = r_reason_sk AND r_reason_sk = 5) t
GROUP BY ss_customer_sk
ORDER BY sumsales, ss_customer_sk
LIMIT 100
"""

QUERIES["q81"] = """
WITH customer_total_return AS (
  SELECT cr_returning_customer_sk AS ctr_customer_sk, ca_state AS ctr_state,
         sum(cr_return_amount) AS ctr_total_return
  FROM catalog_returns, date_dim, customer_address, customer
  WHERE cr_returned_date_sk = d_date_sk AND d_year = 2000
    AND cr_returning_customer_sk = c_customer_sk
    AND c_current_addr_sk = ca_address_sk
  GROUP BY cr_returning_customer_sk, ca_state)
SELECT c_customer_id, c_first_name, c_last_name, ctr_total_return
FROM customer_total_return ctr1, customer
WHERE ctr1.ctr_total_return > (SELECT avg(ctr_total_return) * 1.2
                               FROM customer_total_return ctr2
                               WHERE ctr1.ctr_state = ctr2.ctr_state)
  AND ctr1.ctr_customer_sk = c_customer_sk
ORDER BY c_customer_id
LIMIT 100
"""

QUERIES["q86"] = """
SELECT sum(ws_net_paid) AS total_sum, i_category, i_class,
       grouping(i_category) + grouping(i_class) AS lochierarchy,
       rank() OVER (PARTITION BY grouping(i_category) + grouping(i_class),
                    CASE WHEN grouping(i_class) = 0 THEN i_category END
                    ORDER BY sum(ws_net_paid) DESC) AS rank_within_parent
FROM web_sales, date_dim d1, item
WHERE d1.d_month_seq BETWEEN 12 AND 23
  AND d1.d_date_sk = ws_sold_date_sk AND i_item_sk = ws_item_sk
GROUP BY ROLLUP (i_category, i_class)
ORDER BY lochierarchy DESC, i_category, i_class
LIMIT 100
"""

QUERIES["q2"] = """
WITH wscs AS (
  SELECT ws_sold_date_sk AS sold_date_sk, ws_ext_sales_price AS sales_price
  FROM web_sales
  UNION ALL
  SELECT cs_sold_date_sk, cs_ext_sales_price FROM catalog_sales),
wswscs AS (
  SELECT d_week_seq,
    sum(CASE WHEN d_day_name = 'Sunday' THEN sales_price ELSE NULL END)
      AS sun_sales,
    sum(CASE WHEN d_day_name = 'Monday' THEN sales_price ELSE NULL END)
      AS mon_sales,
    sum(CASE WHEN d_day_name = 'Tuesday' THEN sales_price ELSE NULL END)
      AS tue_sales,
    sum(CASE WHEN d_day_name = 'Wednesday' THEN sales_price ELSE NULL END)
      AS wed_sales,
    sum(CASE WHEN d_day_name = 'Thursday' THEN sales_price ELSE NULL END)
      AS thu_sales,
    sum(CASE WHEN d_day_name = 'Friday' THEN sales_price ELSE NULL END)
      AS fri_sales,
    sum(CASE WHEN d_day_name = 'Saturday' THEN sales_price ELSE NULL END)
      AS sat_sales
  FROM wscs, date_dim WHERE d_date_sk = sold_date_sk GROUP BY d_week_seq),
wk AS (SELECT DISTINCT d_week_seq, d_year FROM date_dim)
SELECT y.d_week_seq AS week1,
       y.sun_sales / z.sun_sales AS r_sun, y.mon_sales / z.mon_sales AS r_mon,
       y.tue_sales / z.tue_sales AS r_tue, y.wed_sales / z.wed_sales AS r_wed,
       y.thu_sales / z.thu_sales AS r_thu, y.fri_sales / z.fri_sales AS r_fri,
       y.sat_sales / z.sat_sales AS r_sat
FROM wswscs y, wk wky, wswscs z, wk wkz
WHERE y.d_week_seq = wky.d_week_seq AND wky.d_year = 1999
  AND z.d_week_seq = wkz.d_week_seq AND wkz.d_year = 2000
  AND y.d_week_seq = z.d_week_seq - 53
ORDER BY y.d_week_seq
"""

# q4/q11/q74: the year_total family (3/2/2-channel year-over-year customer
# growth, 6/4/4-way CTE self joins). catalog_sales has no cs_ext_wholesale_cost
# in the generated subset; cs_wholesale_cost substitutes (same type).
QUERIES["q4"] = """
WITH year_total AS (
  SELECT c_customer_id AS customer_id, c_first_name, c_last_name, d_year,
         sum(((ss_ext_list_price - ss_ext_wholesale_cost
               - ss_ext_discount_amt) + ss_ext_sales_price) / 2)
           AS year_total,
         's' AS sale_type
  FROM customer, store_sales, date_dim
  WHERE c_customer_sk = ss_customer_sk AND ss_sold_date_sk = d_date_sk
  GROUP BY c_customer_id, c_first_name, c_last_name, d_year
  UNION ALL
  SELECT c_customer_id, c_first_name, c_last_name, d_year,
         sum(((cs_ext_list_price - cs_wholesale_cost - cs_ext_discount_amt)
              + cs_ext_sales_price) / 2),
         'c'
  FROM customer, catalog_sales, date_dim
  WHERE c_customer_sk = cs_bill_customer_sk AND cs_sold_date_sk = d_date_sk
  GROUP BY c_customer_id, c_first_name, c_last_name, d_year
  UNION ALL
  SELECT c_customer_id, c_first_name, c_last_name, d_year,
         sum(((ws_ext_list_price - ws_ext_wholesale_cost
               - ws_ext_discount_amt) + ws_ext_sales_price) / 2),
         'w'
  FROM customer, web_sales, date_dim
  WHERE c_customer_sk = ws_bill_customer_sk AND ws_sold_date_sk = d_date_sk
  GROUP BY c_customer_id, c_first_name, c_last_name, d_year)
SELECT t_s_secyear.customer_id, t_s_secyear.c_first_name,
       t_s_secyear.c_last_name
FROM year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_c_firstyear, year_total t_c_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
WHERE t_s_secyear.customer_id = t_s_firstyear.customer_id
  AND t_s_firstyear.customer_id = t_c_secyear.customer_id
  AND t_s_firstyear.customer_id = t_c_firstyear.customer_id
  AND t_s_firstyear.customer_id = t_w_firstyear.customer_id
  AND t_s_firstyear.customer_id = t_w_secyear.customer_id
  AND t_s_firstyear.sale_type = 's' AND t_c_firstyear.sale_type = 'c'
  AND t_w_firstyear.sale_type = 'w' AND t_s_secyear.sale_type = 's'
  AND t_c_secyear.sale_type = 'c' AND t_w_secyear.sale_type = 'w'
  AND t_s_firstyear.d_year = 1999 AND t_s_secyear.d_year = 2000
  AND t_c_firstyear.d_year = 1999 AND t_c_secyear.d_year = 2000
  AND t_w_firstyear.d_year = 1999 AND t_w_secyear.d_year = 2000
  AND t_s_firstyear.year_total > 0 AND t_c_firstyear.year_total > 0
  AND t_w_firstyear.year_total > 0
  AND CASE WHEN t_c_firstyear.year_total > 0
           THEN t_c_secyear.year_total / t_c_firstyear.year_total
           ELSE NULL END
      > CASE WHEN t_s_firstyear.year_total > 0
             THEN t_s_secyear.year_total / t_s_firstyear.year_total
             ELSE NULL END
  AND CASE WHEN t_c_firstyear.year_total > 0
           THEN t_c_secyear.year_total / t_c_firstyear.year_total
           ELSE NULL END
      > CASE WHEN t_w_firstyear.year_total > 0
             THEN t_w_secyear.year_total / t_w_firstyear.year_total
             ELSE NULL END
ORDER BY t_s_secyear.customer_id, t_s_secyear.c_first_name,
         t_s_secyear.c_last_name
LIMIT 100
"""

QUERIES["q11"] = """
WITH year_total AS (
  SELECT c_customer_id AS customer_id, c_first_name, c_last_name, d_year,
         sum(ss_ext_list_price - ss_ext_discount_amt) AS year_total,
         's' AS sale_type
  FROM customer, store_sales, date_dim
  WHERE c_customer_sk = ss_customer_sk AND ss_sold_date_sk = d_date_sk
  GROUP BY c_customer_id, c_first_name, c_last_name, d_year
  UNION ALL
  SELECT c_customer_id, c_first_name, c_last_name, d_year,
         sum(ws_ext_list_price - ws_ext_discount_amt), 'w'
  FROM customer, web_sales, date_dim
  WHERE c_customer_sk = ws_bill_customer_sk AND ws_sold_date_sk = d_date_sk
  GROUP BY c_customer_id, c_first_name, c_last_name, d_year)
SELECT t_s_secyear.customer_id, t_s_secyear.c_first_name,
       t_s_secyear.c_last_name
FROM year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
WHERE t_s_secyear.customer_id = t_s_firstyear.customer_id
  AND t_s_firstyear.customer_id = t_w_secyear.customer_id
  AND t_s_firstyear.customer_id = t_w_firstyear.customer_id
  AND t_s_firstyear.sale_type = 's' AND t_w_firstyear.sale_type = 'w'
  AND t_s_secyear.sale_type = 's' AND t_w_secyear.sale_type = 'w'
  AND t_s_firstyear.d_year = 1999 AND t_s_secyear.d_year = 2000
  AND t_w_firstyear.d_year = 1999 AND t_w_secyear.d_year = 2000
  AND t_s_firstyear.year_total > 0 AND t_w_firstyear.year_total > 0
  AND CASE WHEN t_w_firstyear.year_total > 0
           THEN t_w_secyear.year_total / t_w_firstyear.year_total
           ELSE 0.0 END
      > CASE WHEN t_s_firstyear.year_total > 0
             THEN t_s_secyear.year_total / t_s_firstyear.year_total
             ELSE 0.0 END
ORDER BY t_s_secyear.customer_id, t_s_secyear.c_first_name,
         t_s_secyear.c_last_name
LIMIT 100
"""

QUERIES["q74"] = """
WITH year_total AS (
  SELECT c_customer_id AS customer_id, c_first_name, c_last_name, d_year,
         sum(ss_net_paid) AS year_total, 's' AS sale_type
  FROM customer, store_sales, date_dim
  WHERE c_customer_sk = ss_customer_sk AND ss_sold_date_sk = d_date_sk
    AND d_year IN (1999, 2000)
  GROUP BY c_customer_id, c_first_name, c_last_name, d_year
  UNION ALL
  SELECT c_customer_id, c_first_name, c_last_name, d_year,
         sum(ws_net_paid), 'w'
  FROM customer, web_sales, date_dim
  WHERE c_customer_sk = ws_bill_customer_sk AND ws_sold_date_sk = d_date_sk
    AND d_year IN (1999, 2000)
  GROUP BY c_customer_id, c_first_name, c_last_name, d_year)
SELECT t_s_secyear.customer_id, t_s_secyear.c_first_name,
       t_s_secyear.c_last_name
FROM year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
WHERE t_s_secyear.customer_id = t_s_firstyear.customer_id
  AND t_s_firstyear.customer_id = t_w_secyear.customer_id
  AND t_s_firstyear.customer_id = t_w_firstyear.customer_id
  AND t_s_firstyear.sale_type = 's' AND t_w_firstyear.sale_type = 'w'
  AND t_s_secyear.sale_type = 's' AND t_w_secyear.sale_type = 'w'
  AND t_s_firstyear.d_year = 1999 AND t_s_secyear.d_year = 2000
  AND t_w_firstyear.d_year = 1999 AND t_w_secyear.d_year = 2000
  AND t_s_firstyear.year_total > 0 AND t_w_firstyear.year_total > 0
  AND t_w_secyear.year_total / t_w_firstyear.year_total
      > t_s_secyear.year_total / t_s_firstyear.year_total
ORDER BY t_s_secyear.c_first_name, t_s_secyear.c_last_name,
         t_s_secyear.customer_id
LIMIT 100
"""

QUERIES["q97"] = """
WITH ssci AS (
  SELECT ss_customer_sk AS customer_sk, ss_item_sk AS item_sk
  FROM store_sales, date_dim
  WHERE ss_sold_date_sk = d_date_sk AND d_month_seq BETWEEN 24 AND 35
  GROUP BY ss_customer_sk, ss_item_sk),
csci AS (
  SELECT cs_bill_customer_sk AS customer_sk, cs_item_sk AS item_sk
  FROM catalog_sales, date_dim
  WHERE cs_sold_date_sk = d_date_sk AND d_month_seq BETWEEN 24 AND 35
  GROUP BY cs_bill_customer_sk, cs_item_sk)
SELECT sum(CASE WHEN ssci.customer_sk IS NOT NULL
                 AND csci.customer_sk IS NULL THEN 1 ELSE 0 END)
         AS store_only,
       sum(CASE WHEN ssci.customer_sk IS NULL
                 AND csci.customer_sk IS NOT NULL THEN 1 ELSE 0 END)
         AS catalog_only,
       sum(CASE WHEN ssci.customer_sk IS NOT NULL
                 AND csci.customer_sk IS NOT NULL THEN 1 ELSE 0 END)
         AS store_and_catalog
FROM ssci FULL OUTER JOIN csci
  ON ssci.customer_sk = csci.customer_sk AND ssci.item_sk = csci.item_sk
"""

# q5/q77/q80: per-channel sales+returns rollups. The generated subset has no
# cp_catalog_page_sk on catalog_returns, so the catalog channel ids are call
# centers; web returns reach their site/page through the sales-side join
# (wr_order_number+wr_item_sk), as in the official wsr definition.
QUERIES["q5"] = """
WITH ssr AS (
  SELECT s_store_id AS id, sum(sales_price) AS sales,
         sum(return_amt) AS returns_amt, sum(profit) AS profit,
         sum(net_loss) AS profit_loss
  FROM (SELECT ss_store_sk AS store_sk, ss_sold_date_sk AS date_sk,
               ss_ext_sales_price AS sales_price, ss_net_profit AS profit,
               0.0 AS return_amt, 0.0 AS net_loss
        FROM store_sales
        UNION ALL
        SELECT sr_store_sk, sr_returned_date_sk, 0.0, 0.0,
               sr_return_amt, sr_net_loss
        FROM store_returns) salesreturns, date_dim, store
  WHERE date_sk = d_date_sk AND d_date_sk BETWEEN 2451100 AND 2451114
    AND store_sk = s_store_sk
  GROUP BY s_store_id),
csr AS (
  SELECT cc_call_center_id AS id, sum(sales_price) AS sales,
         sum(return_amt) AS returns_amt, sum(profit) AS profit,
         sum(net_loss) AS profit_loss
  FROM (SELECT cs_call_center_sk AS center_sk, cs_sold_date_sk AS date_sk,
               cs_ext_sales_price AS sales_price, cs_net_profit AS profit,
               0.0 AS return_amt, 0.0 AS net_loss
        FROM catalog_sales
        UNION ALL
        SELECT cr_call_center_sk, cr_returned_date_sk, 0.0, 0.0,
               cr_return_amount, cr_net_loss
        FROM catalog_returns) salesreturns, date_dim, call_center
  WHERE date_sk = d_date_sk AND d_date_sk BETWEEN 2451100 AND 2451114
    AND center_sk = cc_call_center_sk
  GROUP BY cc_call_center_id),
wsr AS (
  SELECT web_site_id AS id, sum(sales_price) AS sales,
         sum(return_amt) AS returns_amt, sum(profit) AS profit,
         sum(net_loss) AS profit_loss
  FROM (SELECT ws_web_site_sk AS site_sk, ws_sold_date_sk AS date_sk,
               ws_ext_sales_price AS sales_price, ws_net_profit AS profit,
               0.0 AS return_amt, 0.0 AS net_loss
        FROM web_sales
        UNION ALL
        SELECT ws_web_site_sk, wr_returned_date_sk, 0.0, 0.0,
               wr_return_amt, wr_net_loss
        FROM web_returns, web_sales
        WHERE wr_item_sk = ws_item_sk AND wr_order_number = ws_order_number
       ) salesreturns, date_dim, web_site
  WHERE date_sk = d_date_sk AND d_date_sk BETWEEN 2451100 AND 2451114
    AND site_sk = web_site_sk
  GROUP BY web_site_id)
SELECT channel, id, sum(sales) AS sales, sum(returns_amt) AS returns_amt,
       sum(profit) AS profit
FROM (SELECT 'store channel' AS channel, id, sales, returns_amt,
             profit - profit_loss AS profit FROM ssr
      UNION ALL
      SELECT 'catalog channel', id, sales, returns_amt,
             profit - profit_loss FROM csr
      UNION ALL
      SELECT 'web channel', id, sales, returns_amt,
             profit - profit_loss FROM wsr) x
GROUP BY ROLLUP (channel, id)
ORDER BY channel, id
"""

QUERIES["q77"] = """
WITH ss AS (
  SELECT s_store_sk, sum(ss_ext_sales_price) AS sales,
         sum(ss_net_profit) AS profit
  FROM store_sales, date_dim, store
  WHERE ss_sold_date_sk = d_date_sk
    AND d_date_sk BETWEEN 2451100 AND 2451129
    AND ss_store_sk = s_store_sk
  GROUP BY s_store_sk),
sr AS (
  SELECT s_store_sk, sum(sr_return_amt) AS returns_amt,
         sum(sr_net_loss) AS profit_loss
  FROM store_returns, date_dim, store
  WHERE sr_returned_date_sk = d_date_sk
    AND d_date_sk BETWEEN 2451100 AND 2451129
    AND sr_store_sk = s_store_sk
  GROUP BY s_store_sk),
cs AS (
  SELECT cs_call_center_sk, sum(cs_ext_sales_price) AS sales,
         sum(cs_net_profit) AS profit
  FROM catalog_sales, date_dim
  WHERE cs_sold_date_sk = d_date_sk
    AND d_date_sk BETWEEN 2451100 AND 2451129
  GROUP BY cs_call_center_sk),
cr AS (
  SELECT cr_call_center_sk, sum(cr_return_amount) AS returns_amt,
         sum(cr_net_loss) AS profit_loss
  FROM catalog_returns, date_dim
  WHERE cr_returned_date_sk = d_date_sk
    AND d_date_sk BETWEEN 2451100 AND 2451129
  GROUP BY cr_call_center_sk),
ws AS (
  SELECT wp_web_page_sk, sum(ws_ext_sales_price) AS sales,
         sum(ws_net_profit) AS profit
  FROM web_sales, date_dim, web_page
  WHERE ws_sold_date_sk = d_date_sk
    AND d_date_sk BETWEEN 2451100 AND 2451129
    AND ws_web_page_sk = wp_web_page_sk
  GROUP BY wp_web_page_sk),
wr AS (
  SELECT wp_web_page_sk, sum(wr_return_amt) AS returns_amt,
         sum(wr_net_loss) AS profit_loss
  FROM web_returns, web_sales, date_dim, web_page
  WHERE wr_item_sk = ws_item_sk AND wr_order_number = ws_order_number
    AND wr_returned_date_sk = d_date_sk
    AND d_date_sk BETWEEN 2451100 AND 2451129
    AND ws_web_page_sk = wp_web_page_sk
  GROUP BY wp_web_page_sk)
SELECT channel, id, sum(sales) AS sales, sum(returns_amt) AS returns_amt,
       sum(profit) AS profit
FROM (SELECT 'store channel' AS channel, ss.s_store_sk AS id, sales,
             coalesce(returns_amt, 0.0) AS returns_amt,
             profit - coalesce(profit_loss, 0.0) AS profit
      FROM ss LEFT JOIN sr ON ss.s_store_sk = sr.s_store_sk
      UNION ALL
      SELECT 'catalog channel', cs.cs_call_center_sk, sales,
             coalesce(returns_amt, 0.0),
             profit - coalesce(profit_loss, 0.0)
      FROM cs LEFT JOIN cr ON cs.cs_call_center_sk = cr.cr_call_center_sk
      UNION ALL
      SELECT 'web channel', ws.wp_web_page_sk, sales,
             coalesce(returns_amt, 0.0),
             profit - coalesce(profit_loss, 0.0)
      FROM ws LEFT JOIN wr ON ws.wp_web_page_sk = wr.wp_web_page_sk) x
GROUP BY ROLLUP (channel, id)
ORDER BY channel, id
"""

QUERIES["q80"] = """
WITH ssr AS (
  SELECT s_store_id AS id,
         sum(ss_ext_sales_price) AS sales,
         sum(coalesce(sr_return_amt, 0.0)) AS returns_amt,
         sum(ss_net_profit - coalesce(sr_net_loss, 0.0)) AS profit
  FROM store_sales
  LEFT JOIN store_returns ON ss_item_sk = sr_item_sk
                          AND ss_ticket_number = sr_ticket_number
  JOIN date_dim ON ss_sold_date_sk = d_date_sk
  JOIN store ON ss_store_sk = s_store_sk
  JOIN item ON ss_item_sk = i_item_sk
  JOIN promotion ON ss_promo_sk = p_promo_sk
  WHERE d_date_sk BETWEEN 2451100 AND 2451129
    AND i_current_price > 50 AND p_channel_tv = 'N'
  GROUP BY s_store_id),
csr AS (
  SELECT cc_call_center_id AS id,
         sum(cs_ext_sales_price) AS sales,
         sum(coalesce(cr_return_amount, 0.0)) AS returns_amt,
         sum(cs_net_profit - coalesce(cr_net_loss, 0.0)) AS profit
  FROM catalog_sales
  LEFT JOIN catalog_returns ON cs_item_sk = cr_item_sk
                            AND cs_order_number = cr_order_number
  JOIN date_dim ON cs_sold_date_sk = d_date_sk
  JOIN call_center ON cs_call_center_sk = cc_call_center_sk
  JOIN item ON cs_item_sk = i_item_sk
  JOIN promotion ON cs_promo_sk = p_promo_sk
  WHERE d_date_sk BETWEEN 2451100 AND 2451129
    AND i_current_price > 50 AND p_channel_tv = 'N'
  GROUP BY cc_call_center_id),
wsr AS (
  SELECT web_site_id AS id,
         sum(ws_ext_sales_price) AS sales,
         sum(coalesce(wr_return_amt, 0.0)) AS returns_amt,
         sum(ws_net_profit - coalesce(wr_net_loss, 0.0)) AS profit
  FROM web_sales
  LEFT JOIN web_returns ON ws_item_sk = wr_item_sk
                        AND ws_order_number = wr_order_number
  JOIN date_dim ON ws_sold_date_sk = d_date_sk
  JOIN web_site ON ws_web_site_sk = web_site_sk
  JOIN item ON ws_item_sk = i_item_sk
  JOIN promotion ON ws_promo_sk = p_promo_sk
  WHERE d_date_sk BETWEEN 2451100 AND 2451129
    AND i_current_price > 50 AND p_channel_tv = 'N'
  GROUP BY web_site_id)
SELECT channel, id, sum(sales) AS sales, sum(returns_amt) AS returns_amt,
       sum(profit) AS profit
FROM (SELECT 'store channel' AS channel, id, sales, returns_amt, profit
      FROM ssr
      UNION ALL
      SELECT 'catalog channel', id, sales, returns_amt, profit FROM csr
      UNION ALL
      SELECT 'web channel', id, sales, returns_amt, profit FROM wsr) x
GROUP BY ROLLUP (channel, id)
ORDER BY channel, id
"""

QUERIES["q75"] = """
WITH all_sales AS (
  SELECT d_year, i_brand_id, i_class_id, i_category_id, i_manufact_id,
         sum(sales_cnt) AS sales_cnt, sum(sales_amt) AS sales_amt
  FROM (SELECT d_year, i_brand_id, i_class_id, i_category_id, i_manufact_id,
               cs_quantity - coalesce(cr_return_quantity, 0) AS sales_cnt,
               cs_ext_sales_price - coalesce(cr_return_amount, 0.0)
                 AS sales_amt
        FROM catalog_sales
        JOIN item ON i_item_sk = cs_item_sk
        JOIN date_dim ON d_date_sk = cs_sold_date_sk
        LEFT JOIN catalog_returns ON cs_order_number = cr_order_number
                                  AND cs_item_sk = cr_item_sk
        WHERE i_category = 'Electronics'
        UNION
        SELECT d_year, i_brand_id, i_class_id, i_category_id, i_manufact_id,
               ss_quantity - coalesce(sr_return_quantity, 0),
               ss_ext_sales_price - coalesce(sr_return_amt, 0.0)
        FROM store_sales
        JOIN item ON i_item_sk = ss_item_sk
        JOIN date_dim ON d_date_sk = ss_sold_date_sk
        LEFT JOIN store_returns ON ss_ticket_number = sr_ticket_number
                                AND ss_item_sk = sr_item_sk
        WHERE i_category = 'Electronics'
        UNION
        SELECT d_year, i_brand_id, i_class_id, i_category_id, i_manufact_id,
               ws_quantity - coalesce(wr_return_quantity, 0),
               ws_ext_sales_price - coalesce(wr_return_amt, 0.0)
        FROM web_sales
        JOIN item ON i_item_sk = ws_item_sk
        JOIN date_dim ON d_date_sk = ws_sold_date_sk
        LEFT JOIN web_returns ON ws_order_number = wr_order_number
                              AND ws_item_sk = wr_item_sk
        WHERE i_category = 'Electronics') sales_detail
  GROUP BY d_year, i_brand_id, i_class_id, i_category_id, i_manufact_id)
SELECT prev_yr.d_year AS prev_year, curr_yr.d_year AS year,
       curr_yr.i_brand_id, curr_yr.i_class_id, curr_yr.i_category_id,
       curr_yr.i_manufact_id, prev_yr.sales_cnt AS prev_yr_cnt,
       curr_yr.sales_cnt AS curr_yr_cnt,
       curr_yr.sales_cnt - prev_yr.sales_cnt AS sales_cnt_diff,
       curr_yr.sales_amt - prev_yr.sales_amt AS sales_amt_diff
FROM all_sales curr_yr, all_sales prev_yr
WHERE curr_yr.i_brand_id = prev_yr.i_brand_id
  AND curr_yr.i_class_id = prev_yr.i_class_id
  AND curr_yr.i_category_id = prev_yr.i_category_id
  AND curr_yr.i_manufact_id = prev_yr.i_manufact_id
  AND curr_yr.d_year = 2000 AND prev_yr.d_year = 1999
  AND cast(curr_yr.sales_cnt AS double) / cast(prev_yr.sales_cnt AS double)
      < 0.9
ORDER BY sales_cnt_diff, sales_amt_diff
LIMIT 100
"""

QUERIES["q78"] = """
WITH ws AS (
  SELECT d_year AS ws_sold_year, ws_item_sk,
         ws_bill_customer_sk AS ws_customer_sk,
         sum(ws_quantity) AS ws_qty, sum(ws_wholesale_cost) AS ws_wc,
         sum(ws_sales_price) AS ws_sp
  FROM web_sales
  LEFT JOIN web_returns ON wr_order_number = ws_order_number
                        AND ws_item_sk = wr_item_sk
  JOIN date_dim ON ws_sold_date_sk = d_date_sk
  WHERE wr_order_number IS NULL
  GROUP BY d_year, ws_item_sk, ws_bill_customer_sk),
cs AS (
  SELECT d_year AS cs_sold_year, cs_item_sk,
         cs_bill_customer_sk AS cs_customer_sk,
         sum(cs_quantity) AS cs_qty, sum(cs_wholesale_cost) AS cs_wc,
         sum(cs_sales_price) AS cs_sp
  FROM catalog_sales
  LEFT JOIN catalog_returns ON cr_order_number = cs_order_number
                            AND cs_item_sk = cr_item_sk
  JOIN date_dim ON cs_sold_date_sk = d_date_sk
  WHERE cr_order_number IS NULL
  GROUP BY d_year, cs_item_sk, cs_bill_customer_sk),
ss AS (
  SELECT d_year AS ss_sold_year, ss_item_sk,
         ss_customer_sk,
         sum(ss_quantity) AS ss_qty, sum(ss_wholesale_cost) AS ss_wc,
         sum(ss_sales_price) AS ss_sp
  FROM store_sales
  LEFT JOIN store_returns ON sr_ticket_number = ss_ticket_number
                          AND ss_item_sk = sr_item_sk
  JOIN date_dim ON ss_sold_date_sk = d_date_sk
  WHERE sr_ticket_number IS NULL
  GROUP BY d_year, ss_item_sk, ss_customer_sk)
SELECT ss.ss_customer_sk, ss.ss_item_sk, ss_qty,
       ss_qty / (coalesce(ws_qty, 0) + coalesce(cs_qty, 0)) AS ratio,
       coalesce(ws_qty, 0) + coalesce(cs_qty, 0) AS other_chan_qty,
       coalesce(ws_wc, 0.0) + coalesce(cs_wc, 0.0) AS other_chan_wholesale,
       coalesce(ws_sp, 0.0) + coalesce(cs_sp, 0.0) AS other_chan_sales_price
FROM ss
LEFT JOIN ws ON ws.ws_sold_year = ss.ss_sold_year
             AND ws.ws_item_sk = ss.ss_item_sk
             AND ws.ws_customer_sk = ss.ss_customer_sk
LEFT JOIN cs ON cs.cs_sold_year = ss.ss_sold_year
             AND cs.cs_item_sk = ss.ss_item_sk
             AND cs.cs_customer_sk = ss.ss_customer_sk
WHERE (coalesce(ws_qty, 0) > 0 OR coalesce(cs_qty, 0) > 0)
  AND ss.ss_sold_year = 2000
ORDER BY ss.ss_customer_sk, ss.ss_item_sk
LIMIT 100
"""

# q8: store has no s_zip in the generated subset — the zip-prefix
# neighborhood match becomes a state match (same shape: literal list
# INTERSECT states with enough preferred customers, joined to stores).
QUERIES["q8"] = """
WITH qualified_states AS (
  SELECT ca_state FROM customer_address
  WHERE ca_state IN ('AL', 'IL', 'MI', 'TN', 'CA', 'NY')
  INTERSECT
  SELECT ca_state FROM
   (SELECT ca_state, count(*) AS cnt
    FROM customer_address, customer
    WHERE ca_address_sk = c_current_addr_sk
      AND c_preferred_cust_flag = 'Y'
    GROUP BY ca_state HAVING count(*) > 40) a)
SELECT s_store_name, sum(ss_net_profit) AS profit
FROM store_sales, date_dim, store, qualified_states
WHERE ss_sold_date_sk = d_date_sk AND d_qoy = 2 AND d_year = 1999
  AND ss_store_sk = s_store_sk AND s_state = ca_state
GROUP BY s_store_name
ORDER BY s_store_name
"""

QUERIES["q49"] = """
SELECT channel, item, return_ratio, return_rank, currency_rank FROM
 (SELECT 'web' AS channel, web.item, web.return_ratio, web.return_rank,
         web.currency_rank
  FROM (SELECT item, return_ratio, currency_ratio,
               rank() OVER (ORDER BY return_ratio) AS return_rank,
               rank() OVER (ORDER BY currency_ratio) AS currency_rank
        FROM (SELECT ws_item_sk AS item,
                     cast(sum(coalesce(wr_return_quantity, 0)) AS double)
                     / cast(sum(coalesce(ws_quantity, 0)) AS double)
                       AS return_ratio,
                     cast(sum(coalesce(wr_return_amt, 0.0)) AS double)
                     / cast(sum(coalesce(ws_net_paid, 0.0)) AS double)
                       AS currency_ratio
              FROM web_sales
              LEFT JOIN web_returns ON ws_order_number = wr_order_number
                                    AND ws_item_sk = wr_item_sk, date_dim
              WHERE wr_return_amt > 100 AND ws_net_profit > 1
                AND ws_net_paid > 0 AND ws_quantity > 0
                AND ws_sold_date_sk = d_date_sk AND d_year = 2000
              GROUP BY ws_item_sk) in_web) web
  WHERE web.return_rank <= 10 OR web.currency_rank <= 10
  UNION
  SELECT 'catalog', c.item, c.return_ratio, c.return_rank, c.currency_rank
  FROM (SELECT item, return_ratio, currency_ratio,
               rank() OVER (ORDER BY return_ratio) AS return_rank,
               rank() OVER (ORDER BY currency_ratio) AS currency_rank
        FROM (SELECT cs_item_sk AS item,
                     cast(sum(coalesce(cr_return_quantity, 0)) AS double)
                     / cast(sum(coalesce(cs_quantity, 0)) AS double)
                       AS return_ratio,
                     cast(sum(coalesce(cr_return_amount, 0.0)) AS double)
                     / cast(sum(coalesce(cs_ext_sales_price, 0.0)) AS double)
                       AS currency_ratio
              FROM catalog_sales
              LEFT JOIN catalog_returns ON cs_order_number = cr_order_number
                                        AND cs_item_sk = cr_item_sk, date_dim
              WHERE cr_return_amount > 100 AND cs_net_profit > 1
                AND cs_ext_sales_price > 0 AND cs_quantity > 0
                AND cs_sold_date_sk = d_date_sk AND d_year = 2000
              GROUP BY cs_item_sk) in_cat) c
  WHERE c.return_rank <= 10 OR c.currency_rank <= 10
  UNION
  SELECT 'store', s.item, s.return_ratio, s.return_rank, s.currency_rank
  FROM (SELECT item, return_ratio, currency_ratio,
               rank() OVER (ORDER BY return_ratio) AS return_rank,
               rank() OVER (ORDER BY currency_ratio) AS currency_rank
        FROM (SELECT ss_item_sk AS item,
                     cast(sum(coalesce(sr_return_quantity, 0)) AS double)
                     / cast(sum(coalesce(ss_quantity, 0)) AS double)
                       AS return_ratio,
                     cast(sum(coalesce(sr_return_amt, 0.0)) AS double)
                     / cast(sum(coalesce(ss_net_paid, 0.0)) AS double)
                       AS currency_ratio
              FROM store_sales
              LEFT JOIN store_returns ON ss_ticket_number = sr_ticket_number
                                      AND ss_item_sk = sr_item_sk, date_dim
              WHERE sr_return_amt > 100 AND ss_net_profit > 1
                AND ss_net_paid > 0 AND ss_quantity > 0
                AND ss_sold_date_sk = d_date_sk AND d_year = 2000
              GROUP BY ss_item_sk) in_store) s
  WHERE s.return_rank <= 10 OR s.currency_rank <= 10) x
ORDER BY channel, return_rank, currency_rank, item
"""

QUERIES["q54"] = """
WITH my_customers AS (
  SELECT DISTINCT c_customer_sk, c_current_addr_sk
  FROM (SELECT cs_sold_date_sk AS sold_date_sk,
               cs_bill_customer_sk AS customer_sk, cs_item_sk AS item_sk
        FROM catalog_sales
        UNION ALL
        SELECT ws_sold_date_sk, ws_bill_customer_sk, ws_item_sk
        FROM web_sales) cs_or_ws_sales, item, date_dim, customer
  WHERE sold_date_sk = d_date_sk AND item_sk = i_item_sk
    AND i_category = 'Music' AND i_class = 'class01'
    AND c_customer_sk = cs_or_ws_sales.customer_sk
    AND d_moy = 3 AND d_year = 2000),
my_revenue AS (
  SELECT c_customer_sk, sum(ss_ext_sales_price) AS revenue
  FROM my_customers, store_sales, customer_address, store, date_dim
  WHERE c_customer_sk = ss_customer_sk
    AND c_current_addr_sk = ca_address_sk
    AND ca_county = s_county AND ca_state = s_state
    AND ss_sold_date_sk = d_date_sk
    AND d_month_seq BETWEEN
        (SELECT DISTINCT d_month_seq + 1 FROM date_dim
         WHERE d_year = 2000 AND d_moy = 3)
        AND
        (SELECT DISTINCT d_month_seq + 3 FROM date_dim
         WHERE d_year = 2000 AND d_moy = 3)
  GROUP BY c_customer_sk),
segments AS (
  SELECT cast((revenue / 50) AS int) AS segment FROM my_revenue)
SELECT segment, count(*) AS num_customers, segment * 50 AS segment_base
FROM segments
GROUP BY segment
ORDER BY segment, num_customers
"""

QUERIES["q56"] = """
WITH ss AS (
  SELECT i_item_id, sum(ss_ext_sales_price) AS total_sales
  FROM store_sales, date_dim, customer_address, item
  WHERE i_item_id IN (SELECT i_item_id FROM item
                      WHERE i_color IN ('blue', 'khaki', 'plum'))
    AND ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
    AND d_year = 2000 AND d_moy = 2
    AND ss_addr_sk = ca_address_sk AND ca_gmt_offset = -5
  GROUP BY i_item_id),
cs AS (
  SELECT i_item_id, sum(cs_ext_sales_price) AS total_sales
  FROM catalog_sales, date_dim, customer_address, item
  WHERE i_item_id IN (SELECT i_item_id FROM item
                      WHERE i_color IN ('blue', 'khaki', 'plum'))
    AND cs_item_sk = i_item_sk AND cs_sold_date_sk = d_date_sk
    AND d_year = 2000 AND d_moy = 2
    AND cs_bill_addr_sk = ca_address_sk AND ca_gmt_offset = -5
  GROUP BY i_item_id),
ws AS (
  SELECT i_item_id, sum(ws_ext_sales_price) AS total_sales
  FROM web_sales, date_dim, customer_address, item
  WHERE i_item_id IN (SELECT i_item_id FROM item
                      WHERE i_color IN ('blue', 'khaki', 'plum'))
    AND ws_item_sk = i_item_sk AND ws_sold_date_sk = d_date_sk
    AND d_year = 2000 AND d_moy = 2
    AND ws_bill_addr_sk = ca_address_sk AND ca_gmt_offset = -5
  GROUP BY i_item_id)
SELECT i_item_id, sum(total_sales) AS total_sales
FROM (SELECT i_item_id, total_sales FROM ss
      UNION ALL
      SELECT i_item_id, total_sales FROM cs
      UNION ALL
      SELECT i_item_id, total_sales FROM ws) tmp1
GROUP BY i_item_id
ORDER BY total_sales, i_item_id
LIMIT 100
"""

QUERIES["q57"] = """
WITH v1 AS (
  SELECT i_category, i_brand, cc_name, d_year, d_moy,
         sum(cs_sales_price) AS sum_sales,
         avg(sum(cs_sales_price)) OVER (PARTITION BY i_category, i_brand,
                                        cc_name, d_year)
           AS avg_monthly_sales,
         rank() OVER (PARTITION BY i_category, i_brand, cc_name
                      ORDER BY d_year, d_moy) AS rn
  FROM item, catalog_sales, date_dim, call_center
  WHERE cs_item_sk = i_item_sk AND cs_sold_date_sk = d_date_sk
    AND cc_call_center_sk = cs_call_center_sk
    AND (d_year = 1999 OR (d_year = 1998 AND d_moy = 12)
         OR (d_year = 2000 AND d_moy = 1))
  GROUP BY i_category, i_brand, cc_name, d_year, d_moy)
SELECT v1.i_category, v1.i_brand, v1.cc_name, v1.d_year, v1.d_moy,
       v1.avg_monthly_sales, v1.sum_sales,
       v1_lag.sum_sales AS psum, v1_lead.sum_sales AS nsum
FROM v1, v1 v1_lag, v1 v1_lead
WHERE v1.i_category = v1_lag.i_category
  AND v1.i_category = v1_lead.i_category
  AND v1.i_brand = v1_lag.i_brand AND v1.i_brand = v1_lead.i_brand
  AND v1.cc_name = v1_lag.cc_name AND v1.cc_name = v1_lead.cc_name
  AND v1.rn = v1_lag.rn + 1 AND v1.rn = v1_lead.rn - 1
  AND v1.d_year = 1999
  AND v1.avg_monthly_sales > 0
  AND abs(v1.sum_sales - v1.avg_monthly_sales) / v1.avg_monthly_sales > 0.1
ORDER BY v1.i_category, v1.i_brand, v1.cc_name, v1.d_moy
"""

QUERIES["q14"] = """
WITH cross_items AS (
  SELECT i_item_sk AS ss_item_sk
  FROM item,
   (SELECT iss.i_brand_id AS brand_id, iss.i_class_id AS class_id,
           iss.i_category_id AS category_id
    FROM store_sales, item iss, date_dim d1
    WHERE ss_item_sk = iss.i_item_sk AND ss_sold_date_sk = d1.d_date_sk
      AND d1.d_year BETWEEN 1999 AND 2001
    INTERSECT
    SELECT ics.i_brand_id, ics.i_class_id, ics.i_category_id
    FROM catalog_sales, item ics, date_dim d2
    WHERE cs_item_sk = ics.i_item_sk AND cs_sold_date_sk = d2.d_date_sk
      AND d2.d_year BETWEEN 1999 AND 2001
    INTERSECT
    SELECT iws.i_brand_id, iws.i_class_id, iws.i_category_id
    FROM web_sales, item iws, date_dim d3
    WHERE ws_item_sk = iws.i_item_sk AND ws_sold_date_sk = d3.d_date_sk
      AND d3.d_year BETWEEN 1999 AND 2001) x
  WHERE i_brand_id = brand_id AND i_class_id = class_id
    AND i_category_id = category_id),
avg_sales AS (
  SELECT avg(quantity * list_price) AS average_sales
  FROM (SELECT ss_quantity AS quantity, ss_list_price AS list_price
        FROM store_sales, date_dim
        WHERE ss_sold_date_sk = d_date_sk AND d_year BETWEEN 1999 AND 2001
        UNION ALL
        SELECT cs_quantity, cs_list_price
        FROM catalog_sales, date_dim
        WHERE cs_sold_date_sk = d_date_sk AND d_year BETWEEN 1999 AND 2001
        UNION ALL
        SELECT ws_quantity, ws_list_price
        FROM web_sales, date_dim
        WHERE ws_sold_date_sk = d_date_sk AND d_year BETWEEN 1999 AND 2001) x)
SELECT channel, i_brand_id, i_class_id, i_category_id, sum(sales) AS sales,
       sum(number_sales) AS number_sales
FROM (SELECT 'store' AS channel, i_brand_id, i_class_id, i_category_id,
             sum(ss_quantity * ss_list_price) AS sales,
             count(*) AS number_sales
      FROM store_sales, item, date_dim
      WHERE ss_item_sk IN (SELECT ss_item_sk FROM cross_items)
        AND ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
        AND d_year = 2001 AND d_moy = 11
      GROUP BY i_brand_id, i_class_id, i_category_id
      HAVING sum(ss_quantity * ss_list_price)
             > (SELECT average_sales FROM avg_sales)
      UNION ALL
      SELECT 'catalog', i_brand_id, i_class_id, i_category_id,
             sum(cs_quantity * cs_list_price), count(*)
      FROM catalog_sales, item, date_dim
      WHERE cs_item_sk IN (SELECT ss_item_sk FROM cross_items)
        AND cs_item_sk = i_item_sk AND cs_sold_date_sk = d_date_sk
        AND d_year = 2001 AND d_moy = 11
      GROUP BY i_brand_id, i_class_id, i_category_id
      HAVING sum(cs_quantity * cs_list_price)
             > (SELECT average_sales FROM avg_sales)
      UNION ALL
      SELECT 'web', i_brand_id, i_class_id, i_category_id,
             sum(ws_quantity * ws_list_price), count(*)
      FROM web_sales, item, date_dim
      WHERE ws_item_sk IN (SELECT ss_item_sk FROM cross_items)
        AND ws_item_sk = i_item_sk AND ws_sold_date_sk = d_date_sk
        AND d_year = 2001 AND d_moy = 11
      GROUP BY i_brand_id, i_class_id, i_category_id
      HAVING sum(ws_quantity * ws_list_price)
             > (SELECT average_sales FROM avg_sales)) y
GROUP BY ROLLUP (channel, i_brand_id, i_class_id, i_category_id)
ORDER BY channel, i_brand_id, i_class_id, i_category_id
"""

# q23: thresholds adapted to the synthetic sf=0.01 domains (items bought
# >4 times over the window; customers above 50% of the max store spend).
QUERIES["q23"] = """
WITH frequent_ss_items AS (
  SELECT i_item_sk AS item_sk, count(*) AS cnt
  FROM store_sales, date_dim, item
  WHERE ss_sold_date_sk = d_date_sk AND ss_item_sk = i_item_sk
    AND d_year IN (1999, 2000)
  GROUP BY i_item_sk
  HAVING count(*) > 4),
max_store_sales AS (
  SELECT max(csales) AS tpcds_cmax
  FROM (SELECT c_customer_sk,
               sum(ss_quantity * ss_sales_price) AS csales
        FROM store_sales, customer, date_dim
        WHERE ss_customer_sk = c_customer_sk AND ss_sold_date_sk = d_date_sk
          AND d_year IN (1999, 2000)
        GROUP BY c_customer_sk) a),
best_ss_customer AS (
  SELECT c_customer_sk
  FROM store_sales, customer
  WHERE ss_customer_sk = c_customer_sk
  GROUP BY c_customer_sk
  HAVING sum(ss_quantity * ss_sales_price)
         > 0.5 * (SELECT tpcds_cmax FROM max_store_sales))
SELECT sum(sales) AS total_sales
FROM (SELECT cs_quantity * cs_list_price AS sales
      FROM catalog_sales, date_dim
      WHERE d_year = 2000 AND d_moy = 3 AND cs_sold_date_sk = d_date_sk
        AND cs_item_sk IN (SELECT item_sk FROM frequent_ss_items)
        AND cs_bill_customer_sk IN
            (SELECT c_customer_sk FROM best_ss_customer)
      UNION ALL
      SELECT ws_quantity * ws_list_price
      FROM web_sales, date_dim
      WHERE d_year = 2000 AND d_moy = 3 AND ws_sold_date_sk = d_date_sk
        AND ws_item_sk IN (SELECT item_sk FROM frequent_ss_items)
        AND ws_bill_customer_sk IN
            (SELECT c_customer_sk FROM best_ss_customer)) x
"""

# q24: store has no s_zip/s_market_id and customer no c_birth_country in
# the generated subset — the same-neighborhood match rides s_state=ca_state
# and the market filter becomes s_number_employees; shape (returns-joined
# store sales, CTE reused in a scalar HAVING threshold) is preserved.
QUERIES["q24"] = """
WITH ssales AS (
  SELECT c_last_name, c_first_name, s_store_name, i_color,
         sum(ss_net_paid) AS netpaid
  FROM store_sales, store_returns, store, item, customer, customer_address
  WHERE ss_ticket_number = sr_ticket_number AND ss_item_sk = sr_item_sk
    AND ss_customer_sk = c_customer_sk AND ss_item_sk = i_item_sk
    AND ss_store_sk = s_store_sk AND c_current_addr_sk = ca_address_sk
    AND s_state = ca_state AND s_number_employees BETWEEN 200 AND 290
  GROUP BY c_last_name, c_first_name, s_store_name, i_color)
SELECT c_last_name, c_first_name, s_store_name, sum(netpaid) AS paid
FROM ssales
WHERE i_color = 'pink'
GROUP BY c_last_name, c_first_name, s_store_name
HAVING sum(netpaid) > (SELECT 0.05 * avg(netpaid) FROM ssales)
ORDER BY c_last_name, c_first_name, s_store_name
"""

# q64: customer first-sales/first-shipto dates and demographics joins are
# absent from the generated subset; the core shape — returns-qualified
# catalog items (cs_ui), the per-(item, store, year) cross_sales rollup,
# and the year-over-year self join — is preserved.
QUERIES["q64"] = """
WITH cs_ui AS (
  SELECT cs_item_sk,
         sum(cs_ext_list_price) AS sale,
         sum(cr_refunded_cash + cr_net_loss) AS refund
  FROM catalog_sales, catalog_returns
  WHERE cs_item_sk = cr_item_sk AND cs_order_number = cr_order_number
  GROUP BY cs_item_sk
  HAVING sum(cs_ext_list_price)
         > 2 * sum(cr_refunded_cash + cr_net_loss)),
cross_sales AS (
  SELECT i_product_name AS product_name, i_item_sk AS item_sk,
         s_store_name AS store_name, d1.d_year AS syear,
         count(*) AS cnt, sum(ss_wholesale_cost) AS s1,
         sum(ss_list_price) AS s2, sum(ss_coupon_amt) AS s3
  FROM store_sales, store_returns, cs_ui, date_dim d1, store, item
  WHERE ss_store_sk = s_store_sk AND ss_sold_date_sk = d1.d_date_sk
    AND ss_item_sk = i_item_sk AND ss_item_sk = sr_item_sk
    AND ss_ticket_number = sr_ticket_number AND ss_item_sk = cs_ui.cs_item_sk
    AND i_color IN ('green', 'red', 'blue', 'pink', 'white', 'black')
    AND i_current_price BETWEEN 1 AND 100
  GROUP BY i_product_name, i_item_sk, s_store_name, d1.d_year)
SELECT cs1.product_name, cs1.store_name, cs1.syear AS year1,
       cs2.syear AS year2, cs1.cnt AS cnt1, cs2.cnt AS cnt2,
       cs1.s1 AS s11, cs1.s2 AS s21, cs1.s3 AS s31,
       cs2.s1 AS s12, cs2.s2 AS s22, cs2.s3 AS s32
FROM cross_sales cs1, cross_sales cs2
WHERE cs1.item_sk = cs2.item_sk AND cs1.syear = 1999
  AND cs2.syear = 2000 AND cs2.cnt <= cs1.cnt
  AND cs1.store_name = cs2.store_name
ORDER BY cs1.product_name, cs1.store_name, cs2.cnt
"""

QUERIES["q70"] = """
SELECT sum(ss_net_profit) AS total_sum, s_state, s_county,
       grouping(s_state) + grouping(s_county) AS lochierarchy
FROM store_sales, date_dim d1, store
WHERE d1.d_month_seq BETWEEN 24 AND 35
  AND d1.d_date_sk = ss_sold_date_sk AND s_store_sk = ss_store_sk
  AND s_state IN
      (SELECT s_state
       FROM (SELECT s_state, rank() OVER (PARTITION BY s_state
                                          ORDER BY sum(ss_net_profit) DESC)
                      AS ranking
             FROM store_sales, store, date_dim
             WHERE d_month_seq BETWEEN 24 AND 35
               AND d_date_sk = ss_sold_date_sk AND s_store_sk = ss_store_sk
             GROUP BY s_state) tmp1
       WHERE ranking <= 5)
GROUP BY ROLLUP (s_state, s_county)
ORDER BY lochierarchy DESC, s_state, s_county
"""

# q72: d3.d_date > d1.d_date + 5 rides the day-indexed date_sk arithmetic
# (d_date_sk IS the day number in the generated calendar).
QUERIES["q72"] = """
SELECT i_item_desc, w_warehouse_name, d1.d_week_seq,
       sum(CASE WHEN p_promo_sk IS NULL THEN 1 ELSE 0 END) AS no_promo,
       sum(CASE WHEN p_promo_sk IS NOT NULL THEN 1 ELSE 0 END) AS promo,
       count(*) AS total_cnt
FROM catalog_sales
JOIN inventory ON cs_item_sk = inv_item_sk
JOIN warehouse ON w_warehouse_sk = inv_warehouse_sk
JOIN item ON i_item_sk = cs_item_sk
JOIN customer_demographics ON cs_bill_cdemo_sk = cd_demo_sk
JOIN household_demographics ON cs_bill_hdemo_sk = hd_demo_sk
JOIN date_dim d1 ON cs_sold_date_sk = d1.d_date_sk
JOIN date_dim d2 ON inv_date_sk = d2.d_date_sk
JOIN date_dim d3 ON cs_ship_date_sk = d3.d_date_sk
LEFT JOIN promotion ON cs_promo_sk = p_promo_sk
LEFT JOIN catalog_returns ON cr_item_sk = cs_item_sk
                          AND cr_order_number = cs_order_number
WHERE d1.d_week_seq = d2.d_week_seq AND inv_quantity_on_hand < cs_quantity
  AND d3.d_date_sk > d1.d_date_sk + 5 AND hd_buy_potential = '>10000'
  AND d1.d_year = 1999 AND cd_marital_status = 'D'
GROUP BY i_item_desc, w_warehouse_name, d1.d_week_seq
ORDER BY total_cnt DESC, i_item_desc, w_warehouse_name, d1.d_week_seq
LIMIT 100
"""

QUERIES["q83"] = """
WITH date_set AS (
  SELECT d_date_sk FROM date_dim
  WHERE d_week_seq IN (SELECT d_week_seq FROM date_dim
                       WHERE d_date IN (date '2000-06-30',
                                        date '2000-09-27',
                                        date '2000-11-17'))),
sr_items AS (
  SELECT i_item_id AS item_id, sum(sr_return_quantity) AS sr_item_qty
  FROM store_returns, item, date_set
  WHERE sr_item_sk = i_item_sk AND sr_returned_date_sk = d_date_sk
  GROUP BY i_item_id),
cr_items AS (
  SELECT i_item_id AS item_id, sum(cr_return_quantity) AS cr_item_qty
  FROM catalog_returns, item, date_set
  WHERE cr_item_sk = i_item_sk AND cr_returned_date_sk = d_date_sk
  GROUP BY i_item_id),
wr_items AS (
  SELECT i_item_id AS item_id, sum(wr_return_quantity) AS wr_item_qty
  FROM web_returns, item, date_set
  WHERE wr_item_sk = i_item_sk AND wr_returned_date_sk = d_date_sk
  GROUP BY i_item_id)
SELECT sr_items.item_id, sr_item_qty,
       sr_item_qty * 1.0 / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0
         * 100 AS sr_dev,
       cr_item_qty,
       cr_item_qty * 1.0 / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0
         * 100 AS cr_dev,
       wr_item_qty,
       wr_item_qty * 1.0 / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0
         * 100 AS wr_dev,
       (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 AS average
FROM sr_items, cr_items, wr_items
WHERE sr_items.item_id = cr_items.item_id
  AND sr_items.item_id = wr_items.item_id
ORDER BY sr_items.item_id, sr_item_qty
"""

# q95: web_sales has no ws_ship_addr_sk / ws_ext_ship_cost in the generated
# subset — ws_bill_addr_sk and ws_ext_list_price substitute (same types).
QUERIES["q95"] = """
WITH ws_wh AS (
  SELECT ws1.ws_order_number
  FROM web_sales ws1, web_sales ws2
  WHERE ws1.ws_order_number = ws2.ws_order_number
    AND ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
SELECT count(DISTINCT ws1.ws_order_number) AS order_count,
       sum(ws_ext_list_price) AS total_shipping_cost,
       sum(ws_net_profit) AS total_net_profit
FROM web_sales ws1, date_dim, customer_address, web_site
WHERE ws1.ws_ship_date_sk = d_date_sk
  AND d_date BETWEEN date '2000-02-01' AND date '2000-04-01'
  AND ws1.ws_bill_addr_sk = ca_address_sk AND ca_state = 'IL'
  AND ws1.ws_web_site_sk = web_site_sk AND web_company_name = 'pri0'
  AND ws1.ws_order_number IN (SELECT ws_order_number FROM ws_wh)
  AND ws1.ws_order_number IN (SELECT wr_order_number
                              FROM web_returns, ws_wh
                              WHERE wr_order_number = ws_wh.ws_order_number)
"""


# q67 (tests/test_tpcds_q67.py: BASELINE.json's TPC-DS entry)
Q67 = """
select * from (
  select i_category, i_class, i_brand, i_product_name, d_year, d_qoy, d_moy,
         s_store_id, sumsales,
         rank() over (partition by i_category order by sumsales desc) rk
  from (
    select i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
           d_moy, s_store_id,
           sum(coalesce(ss_sales_price * ss_quantity, 0)) sumsales
    from store_sales, date_dim, store, item
    where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
      and ss_store_sk = s_store_sk and d_month_seq between 12 and 23
    group by rollup(i_category, i_class, i_brand, i_product_name, d_year,
                    d_qoy, d_moy, s_store_id)
  ) dw1
) dw2
where rk <= 10
order by i_category nulls last, i_class nulls last, i_brand nulls last,
         i_product_name nulls last, d_year nulls last, d_qoy nulls last,
         d_moy nulls last, s_store_id nulls last, sumsales, rk
limit 100
"""

ALL_QUERIES = {**QUERIES, "q67": Q67}

# the 15 queries whose plans hold an LWindow (rank/row_number/avg/sum over
# a window, and q67's rk <= 10 window top-N)
WINDOW_QUERIES = ("q12", "q20", "q36", "q44", "q47", "q49", "q51", "q53",
                  "q57", "q63", "q67", "q70", "q86", "q89", "q98")

# {query: {kernel: calls}} under the kernel strategies (SET segment_strategy
# = 'pallas', join_probe_strategy = 'pallas_sorted', topn_strategy =
# 'pallas'): each kernel wrapper's calls at SF 0.01 on the CPU, where the
# wrapper takes its plain version. Every other query calls none
KERNEL_QUERIES = {
    "q2": {"probe_searchsorted": 1},
    "q4": {"topn_select": 2, "segment_sum": 36},
    "q5": {"segment_sum": 18},
    "q6": {"probe_searchsorted": 1},
    "q11": {"topn_select": 2},
    "q17": {"segment_sum": 2},
    "q30": {"probe_searchsorted": 1},
    "q39": {"topn_select": 1},
    "q41": {"probe_searchsorted": 1},
    "q45": {"probe_searchsorted": 1},
    "q47": {"topn_select": 1},
    "q49": {"segment_sum": 9},
    "q51": {"probe_searchsorted": 4},
    "q58": {"probe_searchsorted": 2},
    "q59": {"topn_select": 2},
    "q70": {"probe_searchsorted": 2},
    "q74": {"topn_select": 2},
    "q75": {"segment_sum": 2},
    "q77": {"segment_sum": 4},
    "q78": {"topn_select": 4, "probe_searchsorted": 10},
    "q80": {"segment_sum": 10},
    "q81": {"probe_searchsorted": 1},
    "q83": {"probe_searchsorted": 2},
    "q84": {"topn_select": 1},
    "q97": {"probe_searchsorted": 4},
}
SEGMENT_SUM_QUERIES = tuple(q for q, k in KERNEL_QUERIES.items()
                            if "segment_sum" in k)
# the queries the kernel strategies run: the window queries, then those
# that launch a kernel
KERNEL_RUN_QUERIES = WINDOW_QUERIES + tuple(
    q for q in KERNEL_QUERIES if q not in WINDOW_QUERIES)
# float cells of a query that launches segment_sum are f32 block sums under
# the kernel strategies: they agree with f64 sums to this relative bound
SEGMENT_SUM_REL = 1e-4
