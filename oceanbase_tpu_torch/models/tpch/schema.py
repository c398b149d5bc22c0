"""TPC-H schema in oceanbase_tpu types.

The workload family the benchmarks run on (BASELINE.md configs). Types pick
the narrowest physical width that holds the TPC-H domain at the target scale
factors (keys int32 up to SF100's 600M lineitem rows need int64 for orderkey
at SF>=78 — orderkey max = SF * 6M * 4; we use int64 for orderkey, int32
elsewhere). Decimals: money DECIMAL(12,2), discounts/tax DECIMAL(9,2).
"""

from __future__ import annotations

from ...core.dtypes import DataType, Schema

D = DataType

LINEITEM = Schema.of(
    l_orderkey=D.int64(),
    l_partkey=D.int32(),
    l_suppkey=D.int32(),
    l_linenumber=D.int8(),
    l_quantity=D.decimal(9, 2),
    l_extendedprice=D.decimal(12, 2),
    l_discount=D.decimal(9, 2),
    l_tax=D.decimal(9, 2),
    l_returnflag=D.varchar(),
    l_linestatus=D.varchar(),
    l_shipdate=D.date(),
    l_commitdate=D.date(),
    l_receiptdate=D.date(),
    l_shipinstruct=D.varchar(),
    l_shipmode=D.varchar(),
)

ORDERS = Schema.of(
    o_orderkey=D.int64(),
    o_custkey=D.int32(),
    o_orderstatus=D.varchar(),
    o_totalprice=D.decimal(12, 2),
    o_orderdate=D.date(),
    o_orderpriority=D.varchar(),
    o_clerk=D.varchar(),
    o_shippriority=D.int32(),
    o_comment=D.varchar(),
)

CUSTOMER = Schema.of(
    c_custkey=D.int32(),
    c_name=D.varchar(),
    c_address=D.varchar(),
    c_nationkey=D.int8(),
    c_phone=D.varchar(),
    c_acctbal=D.decimal(12, 2),
    c_mktsegment=D.varchar(),
    c_comment=D.varchar(),
)

PART = Schema.of(
    p_partkey=D.int32(),
    p_name=D.varchar(),
    p_mfgr=D.varchar(),
    p_brand=D.varchar(),
    p_type=D.varchar(),
    p_size=D.int32(),
    p_container=D.varchar(),
    p_retailprice=D.decimal(12, 2),
)

SUPPLIER = Schema.of(
    s_suppkey=D.int32(),
    s_name=D.varchar(),
    s_address=D.varchar(),
    s_nationkey=D.int8(),
    s_phone=D.varchar(),
    s_acctbal=D.decimal(12, 2),
    s_comment=D.varchar(),
)

PARTSUPP = Schema.of(
    ps_partkey=D.int32(),
    ps_suppkey=D.int32(),
    ps_availqty=D.int32(),
    ps_supplycost=D.decimal(12, 2),
)

NATION = Schema.of(
    n_nationkey=D.int8(),
    n_name=D.varchar(),
    n_regionkey=D.int8(),
)

REGION = Schema.of(
    r_regionkey=D.int8(),
    r_name=D.varchar(),
)

TABLES = {
    "lineitem": LINEITEM,
    "orders": ORDERS,
    "customer": CUSTOMER,
    "part": PART,
    "supplier": SUPPLIER,
    "partsupp": PARTSUPP,
    "nation": NATION,
    "region": REGION,
}

# base cardinalities at SF=1
BASE_ROWS = {
    "lineitem": 6_001_215,
    "orders": 1_500_000,
    "customer": 150_000,
    "part": 200_000,
    "supplier": 10_000,
    "partsupp": 800_000,
    "nation": 25,
    "region": 5,
}
