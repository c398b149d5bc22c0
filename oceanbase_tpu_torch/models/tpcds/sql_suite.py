"""TPC-DS star-join query texts (public TPC-DS specification queries,
restricted to the star-schema subset in schema.py).

Q3 / Q42 / Q52 / Q55 are the classic brand/star shape: fact scan with a
selective dimension filter, two-or-three-way star join, wide GROUP BY,
ORDER BY ... LIMIT 100 — BASELINE config 5's "multi-way hash join, wide
GROUP BY" surface."""

# one tuple of key columns per unique key, the form the executor's
# unique-build check reads (as models/tpch/sql_suite.py gives it); a flat
# tuple of names would be read as single-character keys, leave every
# dimension non-unique and send the star joins through the capacity-bound
# M:N expansion
UNIQUE_KEYS = {
    "date_dim": (("d_date_sk",),),
    "item": (("i_item_sk",),),
    "store": (("s_store_sk",),),
}

QUERIES = {
    3: """
        select dt.d_year, item.i_brand_id as brand_id, item.i_brand as brand,
               sum(ss.ss_ext_sales_price) as sum_agg
        from date_dim dt, store_sales ss, item
        where dt.d_date_sk = ss.ss_sold_date_sk
          and ss.ss_item_sk = item.i_item_sk
          and item.i_manufact_id = 128
          and dt.d_moy = 11
        group by dt.d_year, item.i_brand_id, item.i_brand
        order by dt.d_year, sum_agg desc, brand_id
        limit 100
    """,
    42: """
        select dt.d_year, item.i_category_id, item.i_category,
               sum(ss.ss_ext_sales_price) as s
        from date_dim dt, store_sales ss, item
        where dt.d_date_sk = ss.ss_sold_date_sk
          and ss.ss_item_sk = item.i_item_sk
          and item.i_manager_id = 1
          and dt.d_moy = 11
          and dt.d_year = 2000
        group by dt.d_year, item.i_category_id, item.i_category
        order by s desc, dt.d_year, item.i_category_id, item.i_category
        limit 100
    """,
    52: """
        select dt.d_year, item.i_brand_id as brand_id, item.i_brand as brand,
               sum(ss.ss_ext_sales_price) as ext_price
        from date_dim dt, store_sales ss, item
        where dt.d_date_sk = ss.ss_sold_date_sk
          and ss.ss_item_sk = item.i_item_sk
          and item.i_manager_id = 1
          and dt.d_moy = 11
          and dt.d_year = 2000
        group by dt.d_year, item.i_brand_id, item.i_brand
        order by dt.d_year, ext_price desc, brand_id
        limit 100
    """,
    55: """
        select item.i_brand_id as brand_id, item.i_brand as brand,
               sum(ss.ss_ext_sales_price) as ext_price
        from date_dim dt, store_sales ss, item
        where dt.d_date_sk = ss.ss_sold_date_sk
          and ss.ss_item_sk = item.i_item_sk
          and item.i_manager_id = 28
          and dt.d_moy = 11
          and dt.d_year = 1999
        group by item.i_brand_id, item.i_brand
        order by ext_price desc, brand_id
        limit 100
    """,
}
