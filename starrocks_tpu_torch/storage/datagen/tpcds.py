"""TPC-DS generator: the full 24-table schema (schema-faithful column
subsets, simplified value distributions).

Reference behavior: the TPC-DS kit the reference benchmarks with
(docs/en/benchmarking/TPC_DS_Benchmark.md runs all 99 queries at 1TB;
BASELINE.json lists Q67 as a target config). Row-count scaling follows the
spec's ratios (store_sales 2.88M/SF etc.); dimension content is synthetic
but referentially consistent — returns sample real sales rows, demographic
SKs land in-range — so multi-join queries produce non-degenerate results.
"""

from __future__ import annotations

import datetime

import numpy as np

from ... import types as T
from ...column import HostTable

DEC = T.DECIMAL(7, 2)

CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry",
              "Men", "Music", "Shoes", "Sports", "Women"]
DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
             "Friday", "Saturday"]
STATES = ["AL", "CA", "GA", "IL", "KS", "MI", "NY", "OH", "TN", "TX"]
COUNTIES = [f"{w} County" for w in
            ["Ziebach", "Walker", "Daviess", "Barrow", "Fairfield",
             "Luce", "Richland", "Bronx", "Orange", "Maverick"]]
CITIES = ["Midway", "Fairview", "Oakland", "Glendale", "Centerville",
          "Springdale", "Riverside", "Union", "Salem", "Clinton"]
GENDERS = ["M", "F"]
MARITAL = ["M", "S", "D", "W", "U"]
EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
             "4 yr Degree", "Advanced Degree", "Unknown"]
CREDIT = ["Low Risk", "High Risk", "Good", "Unknown"]
BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000",
                 "0-500", "Unknown"]
SM_TYPES = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "LIBRARY"]
SM_CARRIERS = ["UPS", "FEDEX", "AIRBORNE", "USPS", "DHL"]
COLORS = ["red", "blue", "green", "white", "black", "ivory", "khaki",
          "pink", "plum", "puff"]
UNITS = ["Each", "Dozen", "Case", "Pound", "Ounce", "Gram", "Box"]
SIZES = ["small", "medium", "large", "extra large", "N/A", "petite"]


def _money(rng, lo, hi, n):
    return np.round(rng.uniform(lo, hi, n), 2)


def gen_tpcds(sf: float = 0.01, seed: int = 11) -> dict:
    rng = np.random.default_rng(seed)
    out = {}

    # --- date_dim: 1998-2003 -------------------------------------------------
    start = datetime.date(1998, 1, 1)
    ndays = (datetime.date(2003, 12, 31) - start).days + 1
    dates = [start + datetime.timedelta(days=int(i)) for i in range(ndays)]
    d_sk = np.arange(2_450_000, 2_450_000 + ndays, dtype=np.int64)
    out["date_dim"] = HostTable.from_pydict(
        {
            "d_date_sk": d_sk,
            "d_date": np.array([(d - datetime.date(1970, 1, 1)).days
                                for d in dates], dtype=np.int32),
            "d_year": np.array([d.year for d in dates], dtype=np.int32),
            "d_moy": np.array([d.month for d in dates], dtype=np.int32),
            "d_dom": np.array([d.day for d in dates], dtype=np.int32),
            "d_qoy": np.array([(d.month - 1) // 3 + 1 for d in dates],
                              dtype=np.int32),
            "d_dow": np.array([(d.weekday() + 1) % 7 for d in dates],
                              dtype=np.int32),
            "d_day_name": [DAY_NAMES[(d.weekday() + 1) % 7] for d in dates],
            "d_month_seq": np.array(
                [(d.year - 1998) * 12 + d.month - 1 for d in dates],
                dtype=np.int32),
            "d_week_seq": np.array(
                [((d - start).days + (start.weekday() + 1) % 7) // 7
                 for d in dates], dtype=np.int32),
        },
        types={"d_date_sk": T.BIGINT, "d_date": T.DATE, "d_year": T.INT,
               "d_moy": T.INT, "d_dom": T.INT, "d_qoy": T.INT, "d_dow": T.INT,
               "d_month_seq": T.INT, "d_week_seq": T.INT},
    )

    # --- time_dim: per-minute granularity ------------------------------------
    nmin = 24 * 60
    t_sk = np.arange(nmin, dtype=np.int64)
    out["time_dim"] = HostTable.from_pydict(
        {
            "t_time_sk": t_sk,
            "t_hour": (t_sk // 60).astype(np.int32),
            "t_minute": (t_sk % 60).astype(np.int32),
            "t_time": (t_sk * 60).astype(np.int32),
        },
        types={"t_time_sk": T.BIGINT, "t_hour": T.INT, "t_minute": T.INT,
               "t_time": T.INT},
    )

    # --- item ----------------------------------------------------------------
    ni = max(int(18_000 * sf), 100)
    i_sk = np.arange(1, ni + 1, dtype=np.int64)
    cat_i = rng.integers(0, len(CATEGORIES), ni)
    class_i = rng.integers(0, 16, ni)
    brand_i = rng.integers(0, 50, ni)
    manu_i = rng.integers(1, max(int(1000 * sf), 20) + 1, ni)
    mgr_i = rng.integers(1, 100, ni)
    out["item"] = HostTable.from_pydict(
        {
            "i_item_sk": i_sk,
            "i_item_id": [f"ITEM{k:08d}" for k in i_sk],
            "i_item_desc": [f"desc {k:06d} of the item" for k in i_sk],
            "i_category": [CATEGORIES[i] for i in cat_i],
            "i_category_id": (cat_i + 1).astype(np.int32),
            "i_class": [f"class{c:02d}" for c in class_i],
            "i_class_id": (class_i + 1).astype(np.int32),
            "i_brand": [f"brand{b:02d}" for b in brand_i],
            "i_brand_id": (brand_i + 1).astype(np.int32),
            "i_manufact_id": manu_i.astype(np.int32),
            "i_manufact": [f"manufact{m:04d}" for m in manu_i],
            "i_manager_id": mgr_i.astype(np.int32),
            "i_current_price": _money(rng, 0.5, 120.0, ni),
            "i_color": [COLORS[c] for c in rng.integers(0, len(COLORS), ni)],
            "i_units": [UNITS[u] for u in rng.integers(0, len(UNITS), ni)],
            "i_size": [SIZES[u] for u in rng.integers(0, len(SIZES), ni)],
            "i_product_name": [f"product{p:04d}" for p in range(ni)],
        },
        types={"i_item_sk": T.BIGINT, "i_category_id": T.INT,
               "i_class_id": T.INT, "i_brand_id": T.INT,
               "i_manufact_id": T.INT, "i_manager_id": T.INT,
               "i_current_price": DEC},
    )

    # --- store ---------------------------------------------------------------
    ns = max(int(12 * (1 + np.log2(max(sf, 0.01)))), 4)
    s_sk = np.arange(1, ns + 1, dtype=np.int64)
    out["store"] = HostTable.from_pydict(
        {
            "s_store_sk": s_sk,
            "s_store_id": [f"S{k:04d}" for k in range(ns)],
            "s_store_name": [f"store {chr(97 + k % 26)}" for k in range(ns)],
            "s_number_employees": rng.integers(200, 300, ns).astype(np.int32),
            "s_city": [CITIES[c] for c in rng.integers(0, len(CITIES), ns)],
            "s_county": [COUNTIES[c]
                         for c in rng.integers(0, len(COUNTIES), ns)],
            "s_state": [STATES[c] for c in rng.integers(0, len(STATES), ns)],
            "s_gmt_offset": np.full(ns, -5.0),
        },
        types={"s_store_sk": T.BIGINT, "s_number_employees": T.INT,
               "s_gmt_offset": T.DECIMAL(5, 2)},
    )

    # --- warehouse / ship_mode / web_site / call_center / reason -------------
    nw = max(int(5 * (1 + np.log2(max(sf, 0.01)))), 3)
    w_sk = np.arange(1, nw + 1, dtype=np.int64)
    out["warehouse"] = HostTable.from_pydict(
        {
            "w_warehouse_sk": w_sk,
            "w_warehouse_name": [f"warehouse {k}" for k in range(nw)],
            "w_warehouse_sq_ft": rng.integers(50_000, 1_000_000, nw
                                              ).astype(np.int32),
            "w_state": [STATES[c] for c in rng.integers(0, len(STATES), nw)],
            "w_county": [COUNTIES[c]
                         for c in rng.integers(0, len(COUNTIES), nw)],
        },
        types={"w_warehouse_sk": T.BIGINT, "w_warehouse_sq_ft": T.INT},
    )
    nsm = len(SM_TYPES) * len(SM_CARRIERS)
    out["ship_mode"] = HostTable.from_pydict(
        {
            "sm_ship_mode_sk": np.arange(1, nsm + 1, dtype=np.int64),
            "sm_type": [SM_TYPES[k % len(SM_TYPES)] for k in range(nsm)],
            "sm_carrier": [SM_CARRIERS[k // len(SM_TYPES)]
                           for k in range(nsm)],
        },
        types={"sm_ship_mode_sk": T.BIGINT},
    )
    nweb = max(int(6 * (1 + np.log2(max(sf, 0.01)))), 2)
    out["web_site"] = HostTable.from_pydict(
        {
            "web_site_sk": np.arange(1, nweb + 1, dtype=np.int64),
            "web_site_id": [f"WEB{k:06d}" for k in range(nweb)],
            "web_name": [f"site_{k}" for k in range(nweb)],
            "web_company_name": [f"pri{k % 3}" for k in range(nweb)],
        },
        types={"web_site_sk": T.BIGINT},
    )
    ncc = max(int(4 * (1 + np.log2(max(sf, 0.01)))), 2)
    out["call_center"] = HostTable.from_pydict(
        {
            "cc_call_center_sk": np.arange(1, ncc + 1, dtype=np.int64),
            "cc_call_center_id": [f"CC{k:04d}" for k in range(ncc)],
            "cc_name": [f"center {k}" for k in range(ncc)],
            "cc_county": [COUNTIES[c]
                          for c in rng.integers(0, len(COUNTIES), ncc)],
        },
        types={"cc_call_center_sk": T.BIGINT},
    )
    nreason = 35
    out["reason"] = HostTable.from_pydict(
        {
            "r_reason_sk": np.arange(1, nreason + 1, dtype=np.int64),
            "r_reason_desc": [f"reason {k:02d}" for k in range(nreason)],
        },
        types={"r_reason_sk": T.BIGINT},
    )
    nwp = max(int(60 * sf), 10)
    out["web_page"] = HostTable.from_pydict(
        {
            "wp_web_page_sk": np.arange(1, nwp + 1, dtype=np.int64),
            "wp_char_count": rng.integers(100, 8000, nwp).astype(np.int32),
        },
        types={"wp_web_page_sk": T.BIGINT, "wp_char_count": T.INT},
    )
    ncp = max(int(11_000 * sf), 40)
    out["catalog_page"] = HostTable.from_pydict(
        {
            "cp_catalog_page_sk": np.arange(1, ncp + 1, dtype=np.int64),
            "cp_catalog_page_id": [f"CP{k:08d}" for k in range(ncp)],
        },
        types={"cp_catalog_page_sk": T.BIGINT},
    )

    # --- demographics --------------------------------------------------------
    ncd = 2000  # all-combination cross like the spec's 1.92M, subsampled
    cd_sk = np.arange(1, ncd + 1, dtype=np.int64)
    out["customer_demographics"] = HostTable.from_pydict(
        {
            "cd_demo_sk": cd_sk,
            "cd_gender": [GENDERS[k % 2] for k in range(ncd)],
            "cd_marital_status": [MARITAL[(k // 2) % 5] for k in range(ncd)],
            "cd_education_status": [EDUCATION[(k // 10) % 7]
                                    for k in range(ncd)],
            "cd_purchase_estimate": ((cd_sk % 20) * 500 + 500
                                     ).astype(np.int32),
            "cd_credit_rating": [CREDIT[(k // 70) % 4] for k in range(ncd)],
            "cd_dep_count": (cd_sk % 7).astype(np.int32),
            "cd_dep_employed_count": (cd_sk % 5).astype(np.int32),
            "cd_dep_college_count": (cd_sk % 3).astype(np.int32),
        },
        types={"cd_demo_sk": T.BIGINT, "cd_purchase_estimate": T.INT,
               "cd_dep_count": T.INT, "cd_dep_employed_count": T.INT,
               "cd_dep_college_count": T.INT},
    )
    nib = 20
    out["income_band"] = HostTable.from_pydict(
        {
            "ib_income_band_sk": np.arange(1, nib + 1, dtype=np.int64),
            "ib_lower_bound": (np.arange(nib) * 10_000).astype(np.int32),
            "ib_upper_bound": ((np.arange(nib) + 1) * 10_000
                               ).astype(np.int32),
        },
        types={"ib_income_band_sk": T.BIGINT, "ib_lower_bound": T.INT,
               "ib_upper_bound": T.INT},
    )
    nhd = 720
    hd_sk = np.arange(1, nhd + 1, dtype=np.int64)
    out["household_demographics"] = HostTable.from_pydict(
        {
            "hd_demo_sk": hd_sk,
            "hd_income_band_sk": (hd_sk % nib + 1).astype(np.int64),
            "hd_buy_potential": [BUY_POTENTIAL[k % 6] for k in range(nhd)],
            "hd_dep_count": (hd_sk % 10).astype(np.int32),
            "hd_vehicle_count": (hd_sk % 5).astype(np.int32) - 1,
        },
        types={"hd_demo_sk": T.BIGINT, "hd_income_band_sk": T.BIGINT,
               "hd_dep_count": T.INT, "hd_vehicle_count": T.INT},
    )

    # --- customer + address --------------------------------------------------
    nca = max(int(50_000 * sf), 300)
    ca_sk = np.arange(1, nca + 1, dtype=np.int64)
    out["customer_address"] = HostTable.from_pydict(
        {
            "ca_address_sk": ca_sk,
            "ca_city": [CITIES[c] for c in rng.integers(0, len(CITIES), nca)],
            "ca_county": [COUNTIES[c]
                          for c in rng.integers(0, len(COUNTIES), nca)],
            "ca_state": [STATES[c] for c in rng.integers(0, len(STATES), nca)],
            "ca_zip": [f"{z:05d}" for z in rng.integers(10000, 99999, nca)],
            "ca_country": ["United States"] * nca,
            "ca_gmt_offset": np.where(rng.random(nca) < 0.3, -7.0, -5.0),
        },
        types={"ca_address_sk": T.BIGINT, "ca_gmt_offset": T.DECIMAL(5, 2)},
    )
    nc = max(int(100_000 * sf), 500)
    c_sk = np.arange(1, nc + 1, dtype=np.int64)
    out["customer"] = HostTable.from_pydict(
        {
            "c_customer_sk": c_sk,
            "c_customer_id": [f"CUST{k:010d}" for k in c_sk],
            "c_current_cdemo_sk": rng.integers(1, ncd + 1, nc
                                               ).astype(np.int64),
            "c_current_hdemo_sk": rng.integers(1, nhd + 1, nc
                                               ).astype(np.int64),
            "c_current_addr_sk": rng.integers(1, nca + 1, nc
                                              ).astype(np.int64),
            "c_first_name": [f"First{k % 199:03d}" for k in c_sk],
            "c_last_name": [f"Last{k % 499:03d}" for k in c_sk],
            "c_preferred_cust_flag": ["Y" if k % 2 else "N" for k in c_sk],
            "c_birth_year": (1920 + (c_sk % 73)).astype(np.int32),
            "c_birth_month": (c_sk % 12 + 1).astype(np.int32),
        },
        types={"c_customer_sk": T.BIGINT, "c_current_cdemo_sk": T.BIGINT,
               "c_current_hdemo_sk": T.BIGINT, "c_current_addr_sk": T.BIGINT,
               "c_birth_year": T.INT, "c_birth_month": T.INT},
    )

    # --- promotion -----------------------------------------------------------
    nprom = max(int(300 * sf), 30)
    p_sk = np.arange(1, nprom + 1, dtype=np.int64)

    def yn(p):
        return ["Y" if x < p else "N" for x in rng.random(nprom)]

    out["promotion"] = HostTable.from_pydict(
        {
            "p_promo_sk": p_sk,
            "p_channel_dmail": yn(0.5),
            "p_channel_email": yn(0.3),
            "p_channel_tv": yn(0.3),
            "p_channel_event": yn(0.4),
        },
        types={"p_promo_sk": T.BIGINT},
    )

    # --- fact helpers --------------------------------------------------------
    def base_fact(n):
        """Shared FK + pricing columns for a sales fact of n rows."""
        qty = rng.integers(1, 100, n).astype(np.int32)
        wholesale = _money(rng, 1.0, 100.0, n)
        list_p = np.round(wholesale * rng.uniform(1.0, 2.0, n), 2)
        disc = rng.uniform(0.0, 0.6, n)
        sales_p = np.round(list_p * (1 - disc), 2)
        ext_list = np.round(list_p * qty, 2)
        ext_sales = np.round(sales_p * qty, 2)
        ext_wh = np.round(wholesale * qty, 2)
        ext_disc = np.round(ext_list - ext_sales, 2)
        coupon = np.where(rng.random(n) < 0.1,
                          np.round(ext_sales * 0.1, 2), 0.0)
        net_paid = np.round(ext_sales - coupon, 2)
        tax = np.round(net_paid * 0.08, 2)
        profit = np.round(net_paid - ext_wh, 2)
        date_idx = rng.integers(0, ndays, n)
        return dict(
            date_idx=date_idx,
            date_sk=d_sk[date_idx],
            time_sk=rng.integers(0, nmin, n).astype(np.int64),
            item_sk=rng.integers(1, ni + 1, n).astype(np.int64),
            cust_sk=rng.integers(1, nc + 1, n).astype(np.int64),
            cdemo_sk=rng.integers(1, ncd + 1, n).astype(np.int64),
            hdemo_sk=rng.integers(1, nhd + 1, n).astype(np.int64),
            addr_sk=rng.integers(1, nca + 1, n).astype(np.int64),
            promo_sk=rng.integers(1, nprom + 1, n).astype(np.int64),
            # ~5% of sales carry no promotion: NULL FK (the reference data
            # has nullable fact FKs; q76-class queries count them)
            promo_valid=rng.random(n) >= 0.05,
            qty=qty, wholesale=wholesale, list_p=list_p, sales_p=sales_p,
            ext_list=ext_list, ext_sales=ext_sales, ext_wh=ext_wh,
            ext_disc=ext_disc, coupon=coupon, net_paid=net_paid, tax=tax,
            profit=profit,
        )

    def later_date(date_idx, lo, hi, n):
        return d_sk[np.minimum(date_idx + rng.integers(lo, hi, n), ndays - 1)]

    # --- store_sales + store_returns ----------------------------------------
    nss = max(int(2_880_000 * sf), 2000)
    f = base_fact(nss)
    ss_ticket = np.arange(1, nss + 1, dtype=np.int64)
    ss_store = rng.integers(1, ns + 1, nss).astype(np.int64)
    out["store_sales"] = HostTable.from_pydict(
        {
            "ss_sold_date_sk": f["date_sk"],
            "ss_sold_time_sk": f["time_sk"],
            "ss_item_sk": f["item_sk"],
            "ss_customer_sk": f["cust_sk"],
            "ss_cdemo_sk": f["cdemo_sk"],
            "ss_hdemo_sk": f["hdemo_sk"],
            "ss_addr_sk": f["addr_sk"],
            "ss_store_sk": ss_store,
            "ss_promo_sk": f["promo_sk"],
            "ss_ticket_number": ss_ticket,
            "ss_quantity": f["qty"],
            "ss_wholesale_cost": f["wholesale"],
            "ss_list_price": f["list_p"],
            "ss_sales_price": f["sales_p"],
            "ss_ext_discount_amt": f["ext_disc"],
            "ss_ext_sales_price": f["ext_sales"],
            "ss_ext_wholesale_cost": f["ext_wh"],
            "ss_ext_list_price": f["ext_list"],
            "ss_ext_tax": f["tax"],
            "ss_coupon_amt": f["coupon"],
            "ss_net_paid": f["net_paid"],
            "ss_net_profit": f["profit"],
        },
        types={"ss_sold_date_sk": T.BIGINT, "ss_sold_time_sk": T.BIGINT,
               "ss_item_sk": T.BIGINT, "ss_customer_sk": T.BIGINT,
               "ss_cdemo_sk": T.BIGINT, "ss_hdemo_sk": T.BIGINT,
               "ss_addr_sk": T.BIGINT, "ss_store_sk": T.BIGINT,
               "ss_promo_sk": T.BIGINT, "ss_ticket_number": T.BIGINT,
               "ss_quantity": T.INT, "ss_wholesale_cost": DEC,
               "ss_list_price": DEC, "ss_sales_price": DEC,
               "ss_ext_discount_amt": DEC, "ss_ext_sales_price": DEC,
               "ss_ext_wholesale_cost": DEC, "ss_ext_list_price": DEC,
               "ss_ext_tax": DEC, "ss_coupon_amt": DEC, "ss_net_paid": DEC,
               "ss_net_profit": DEC},
    )
    out["store_sales"].valids["ss_promo_sk"] = f["promo_valid"]
    nsr = max(nss // 10, 200)
    ridx = rng.choice(nss, nsr, replace=False)
    ret_qty = np.minimum(f["qty"][ridx],
                         rng.integers(1, 100, nsr)).astype(np.int32)
    ret_amt = np.round(f["sales_p"][ridx] * ret_qty, 2)
    out["store_returns"] = HostTable.from_pydict(
        {
            "sr_returned_date_sk": later_date(f["date_idx"][ridx], 1, 60, nsr),
            "sr_item_sk": f["item_sk"][ridx],
            "sr_customer_sk": f["cust_sk"][ridx],
            "sr_cdemo_sk": f["cdemo_sk"][ridx],
            "sr_store_sk": ss_store[ridx],
            "sr_reason_sk": rng.integers(1, nreason + 1, nsr
                                         ).astype(np.int64),
            "sr_ticket_number": ss_ticket[ridx],
            "sr_return_quantity": ret_qty,
            "sr_return_amt": ret_amt,
            "sr_net_loss": np.round(ret_amt * 0.5 + 10, 2),
        },
        types={"sr_returned_date_sk": T.BIGINT, "sr_item_sk": T.BIGINT,
               "sr_customer_sk": T.BIGINT, "sr_cdemo_sk": T.BIGINT,
               "sr_store_sk": T.BIGINT, "sr_reason_sk": T.BIGINT,
               "sr_ticket_number": T.BIGINT, "sr_return_quantity": T.INT,
               "sr_return_amt": DEC, "sr_net_loss": DEC},
    )

    # --- catalog_sales + catalog_returns ------------------------------------
    ncs = max(int(1_440_000 * sf), 1000)
    f = base_fact(ncs)
    # ~3 lines per order (multi-warehouse orders make Q16-style
    # EXISTS-other-line predicates non-degenerate)
    cs_order = np.sort(rng.integers(1, max(ncs // 3, 10) + 1, ncs)
                       ).astype(np.int64)
    cs_cc = rng.integers(1, ncc + 1, ncs).astype(np.int64)
    out["catalog_sales"] = HostTable.from_pydict(
        {
            "cs_sold_date_sk": f["date_sk"],
            "cs_ship_date_sk": later_date(f["date_idx"], 1, 120, ncs),
            "cs_bill_customer_sk": f["cust_sk"],
            "cs_bill_cdemo_sk": f["cdemo_sk"],
            "cs_bill_hdemo_sk": f["hdemo_sk"],
            "cs_bill_addr_sk": f["addr_sk"],
            "cs_call_center_sk": cs_cc,
            "cs_ship_mode_sk": rng.integers(1, nsm + 1, ncs
                                            ).astype(np.int64),
            "cs_warehouse_sk": rng.integers(1, nw + 1, ncs).astype(np.int64),
            "cs_item_sk": f["item_sk"],
            "cs_promo_sk": f["promo_sk"],
            "cs_order_number": cs_order,
            "cs_quantity": f["qty"],
            "cs_wholesale_cost": f["wholesale"],
            "cs_list_price": f["list_p"],
            "cs_sales_price": f["sales_p"],
            "cs_ext_discount_amt": f["ext_disc"],
            "cs_ext_sales_price": f["ext_sales"],
            "cs_ext_list_price": f["ext_list"],
            "cs_coupon_amt": f["coupon"],
            "cs_net_profit": f["profit"],
        },
        types={"cs_sold_date_sk": T.BIGINT, "cs_ship_date_sk": T.BIGINT,
               "cs_bill_customer_sk": T.BIGINT, "cs_bill_cdemo_sk": T.BIGINT,
               "cs_bill_hdemo_sk": T.BIGINT, "cs_bill_addr_sk": T.BIGINT,
               "cs_call_center_sk": T.BIGINT, "cs_ship_mode_sk": T.BIGINT,
               "cs_warehouse_sk": T.BIGINT, "cs_item_sk": T.BIGINT,
               "cs_promo_sk": T.BIGINT, "cs_order_number": T.BIGINT,
               "cs_quantity": T.INT, "cs_wholesale_cost": DEC,
               "cs_list_price": DEC, "cs_sales_price": DEC,
               "cs_ext_discount_amt": DEC, "cs_ext_sales_price": DEC,
               "cs_ext_list_price": DEC, "cs_coupon_amt": DEC,
               "cs_net_profit": DEC},
    )
    out["catalog_sales"].valids["cs_promo_sk"] = f["promo_valid"]
    ncr = max(ncs // 10, 120)
    ridx = rng.choice(ncs, ncr, replace=False)
    ret_qty = np.minimum(f["qty"][ridx],
                         rng.integers(1, 100, ncr)).astype(np.int32)
    ret_amt = np.round(f["sales_p"][ridx] * ret_qty, 2)
    out["catalog_returns"] = HostTable.from_pydict(
        {
            "cr_returned_date_sk": later_date(f["date_idx"][ridx], 1, 60, ncr),
            "cr_item_sk": f["item_sk"][ridx],
            "cr_returning_customer_sk": f["cust_sk"][ridx],
            "cr_call_center_sk": cs_cc[ridx],
            "cr_order_number": cs_order[ridx],
            "cr_return_quantity": ret_qty,
            "cr_return_amount": ret_amt,
            "cr_refunded_cash": np.round(ret_amt * 0.8, 2),
            "cr_net_loss": np.round(ret_amt * 0.5 + 10, 2),
        },
        types={"cr_returned_date_sk": T.BIGINT, "cr_item_sk": T.BIGINT,
               "cr_returning_customer_sk": T.BIGINT,
               "cr_call_center_sk": T.BIGINT, "cr_order_number": T.BIGINT,
               "cr_return_quantity": T.INT, "cr_return_amount": DEC,
               "cr_refunded_cash": DEC, "cr_net_loss": DEC},
    )

    # --- web_sales + web_returns --------------------------------------------
    nws = max(int(720_000 * sf), 600)
    f = base_fact(nws)
    ws_order = np.sort(rng.integers(1, max(nws // 3, 10) + 1, nws)
                       ).astype(np.int64)
    out["web_sales"] = HostTable.from_pydict(
        {
            "ws_sold_date_sk": f["date_sk"],
            "ws_sold_time_sk": f["time_sk"],
            "ws_ship_date_sk": later_date(f["date_idx"], 1, 120, nws),
            "ws_item_sk": f["item_sk"],
            "ws_bill_customer_sk": f["cust_sk"],
            "ws_bill_addr_sk": f["addr_sk"],
            "ws_web_page_sk": rng.integers(1, nwp + 1, nws).astype(np.int64),
            "ws_web_site_sk": rng.integers(1, nweb + 1, nws
                                           ).astype(np.int64),
            "ws_ship_mode_sk": rng.integers(1, nsm + 1, nws
                                            ).astype(np.int64),
            "ws_warehouse_sk": rng.integers(1, nw + 1, nws).astype(np.int64),
            "ws_promo_sk": f["promo_sk"],
            "ws_order_number": ws_order,
            "ws_quantity": f["qty"],
            "ws_wholesale_cost": f["wholesale"],
            "ws_list_price": f["list_p"],
            "ws_sales_price": f["sales_p"],
            "ws_ext_discount_amt": f["ext_disc"],
            "ws_ext_sales_price": f["ext_sales"],
            "ws_ext_wholesale_cost": f["ext_wh"],
            "ws_ext_list_price": f["ext_list"],
            "ws_net_paid": f["net_paid"],
            "ws_net_profit": f["profit"],
        },
        types={"ws_sold_date_sk": T.BIGINT, "ws_sold_time_sk": T.BIGINT,
               "ws_ship_date_sk": T.BIGINT, "ws_item_sk": T.BIGINT,
               "ws_bill_customer_sk": T.BIGINT, "ws_bill_addr_sk": T.BIGINT,
               "ws_web_page_sk": T.BIGINT, "ws_web_site_sk": T.BIGINT,
               "ws_ship_mode_sk": T.BIGINT, "ws_warehouse_sk": T.BIGINT,
               "ws_promo_sk": T.BIGINT, "ws_order_number": T.BIGINT,
               "ws_quantity": T.INT, "ws_wholesale_cost": DEC,
               "ws_list_price": DEC, "ws_sales_price": DEC,
               "ws_ext_discount_amt": DEC, "ws_ext_sales_price": DEC,
               "ws_ext_wholesale_cost": DEC, "ws_ext_list_price": DEC,
               "ws_net_paid": DEC, "ws_net_profit": DEC},
    )
    out["web_sales"].valids["ws_promo_sk"] = f["promo_valid"]
    nwr = max(nws // 10, 80)
    ridx = rng.choice(nws, nwr, replace=False)
    ret_qty = np.minimum(f["qty"][ridx],
                         rng.integers(1, 100, nwr)).astype(np.int32)
    ret_amt = np.round(f["sales_p"][ridx] * ret_qty, 2)
    out["web_returns"] = HostTable.from_pydict(
        {
            "wr_returned_date_sk": later_date(f["date_idx"][ridx], 1, 60, nwr),
            "wr_item_sk": f["item_sk"][ridx],
            "wr_refunded_cdemo_sk": f["cdemo_sk"][ridx],
            "wr_returning_cdemo_sk": f["cdemo_sk"][ridx],
            "wr_refunded_addr_sk": f["addr_sk"][ridx],
            "wr_reason_sk": rng.integers(1, nreason + 1, nwr
                                         ).astype(np.int64),
            "wr_order_number": ws_order[ridx],
            "wr_return_quantity": ret_qty,
            "wr_return_amt": ret_amt,
            "wr_fee": _money(rng, 0.5, 100.0, nwr),
            "wr_net_loss": np.round(ret_amt * 0.5 + 10, 2),
        },
        types={"wr_returned_date_sk": T.BIGINT, "wr_item_sk": T.BIGINT,
               "wr_refunded_cdemo_sk": T.BIGINT,
               "wr_returning_cdemo_sk": T.BIGINT,
               "wr_refunded_addr_sk": T.BIGINT, "wr_reason_sk": T.BIGINT,
               "wr_order_number": T.BIGINT, "wr_return_quantity": T.INT,
               "wr_return_amt": DEC, "wr_fee": DEC, "wr_net_loss": DEC},
    )

    # --- inventory (weekly snapshots) ---------------------------------------
    week_starts = d_sk[::7]
    ninv_items = min(ni, max(int(ni * 0.25), 50))
    inv_items = rng.choice(i_sk, ninv_items, replace=False)
    grid_d, grid_i, grid_w = np.meshgrid(
        week_starts, inv_items, np.arange(1, nw + 1, dtype=np.int64),
        indexing="ij")
    out["inventory"] = HostTable.from_pydict(
        {
            "inv_date_sk": grid_d.ravel(),
            "inv_item_sk": grid_i.ravel(),
            "inv_warehouse_sk": grid_w.ravel(),
            "inv_quantity_on_hand": rng.integers(
                0, 1000, grid_d.size).astype(np.int32),
        },
        types={"inv_date_sk": T.BIGINT, "inv_item_sk": T.BIGINT,
               "inv_warehouse_sk": T.BIGINT, "inv_quantity_on_hand": T.INT},
    )
    return out


TPCDS_UNIQUE_KEYS = {
    "date_dim": [("d_date_sk",)],
    "time_dim": [("t_time_sk",)],
    "item": [("i_item_sk",)],
    "store": [("s_store_sk",)],
    "warehouse": [("w_warehouse_sk",)],
    "ship_mode": [("sm_ship_mode_sk",)],
    "web_site": [("web_site_sk",)],
    "call_center": [("cc_call_center_sk",)],
    "reason": [("r_reason_sk",)],
    "web_page": [("wp_web_page_sk",)],
    "catalog_page": [("cp_catalog_page_sk",)],
    "customer": [("c_customer_sk",)],
    "customer_address": [("ca_address_sk",)],
    "customer_demographics": [("cd_demo_sk",)],
    "household_demographics": [("hd_demo_sk",)],
    "income_band": [("ib_income_band_sk",)],
    "promotion": [("p_promo_sk",)],
}


def tpcds_catalog(sf: float = 0.01, seed: int = 11):
    from ..catalog import Catalog

    cat = Catalog()
    for name, ht in gen_tpcds(sf, seed).items():
        cat.register(name, ht, TPCDS_UNIQUE_KEYS.get(name, ()))
    return cat
