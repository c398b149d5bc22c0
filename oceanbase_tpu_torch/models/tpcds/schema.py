"""TPC-DS star-schema subset: the dimensional core the star-join suite
needs (BASELINE config 5). Fact table store_sales plus the three
dimensions the classic brand/star queries (Q3/Q42/Q52/Q55) touch.

Column types follow the TPC-DS spec (surrogate int keys, decimal money);
names keep the spec's prefixes so the public query texts run unmodified."""

from ...core.dtypes import DataType as D, Schema

DATE_DIM = Schema.of(
    d_date_sk=D.int64(),
    d_date=D.date(),
    d_year=D.int32(),
    d_moy=D.int32(),
    d_dom=D.int32(),
)

ITEM = Schema.of(
    i_item_sk=D.int64(),
    i_brand_id=D.int32(),
    i_brand=D.varchar(),
    i_manufact_id=D.int32(),
    i_category_id=D.int32(),
    i_category=D.varchar(),
    i_manager_id=D.int32(),
)

STORE = Schema.of(
    s_store_sk=D.int64(),
    s_store_name=D.varchar(),
    s_state=D.varchar(),
)

STORE_SALES = Schema.of(
    ss_sold_date_sk=D.int64(),
    ss_item_sk=D.int64(),
    ss_store_sk=D.int64(),
    ss_customer_sk=D.int64(),
    ss_quantity=D.int32(),
    ss_ext_sales_price=D.decimal(12, 2),
    ss_net_profit=D.decimal(12, 2),
)

TABLES = {
    "date_dim": DATE_DIM,
    "item": ITEM,
    "store": STORE,
    "store_sales": STORE_SALES,
}
