"""Catalog and batches: the port's copied TPC-H generator, its tables built
from plain numpy, and batch upload / host round-trips against the JAX
package."""

import numpy as np
import pytest

from oceanbase_tpu.core.column import batch_to_host as j_to_host
from oceanbase_tpu.core.column import make_batch as j_make
from oceanbase_tpu.models.tpch import datagen as JD
from oceanbase_tpu_torch.core.column import batch_to_host as t_to_host
from oceanbase_tpu_torch.core.column import make_batch as t_make
from oceanbase_tpu_torch.core.table import table_from_arrays
from oceanbase_tpu_torch.models.tpch import datagen as TD

TABLES = ["region", "nation", "supplier", "customer", "part", "partsupp",
          "orders", "lineitem"]


@pytest.fixture(scope="module")
def both():
    return JD.generate(sf=0.01, seed=19920101), \
        TD.generate(sf=0.01, seed=19920101)


def _fields(t):
    return [(f.name, f.dtype.kind.value, f.dtype.precision, f.dtype.scale,
             f.dtype.nullable) for f in t.schema.fields]


@pytest.mark.parametrize("name", TABLES)
def test_datagen_bit_identical(both, name):
    jt, tt = both[0][name], both[1][name]
    assert _fields(jt) == _fields(tt)
    assert sorted(jt.data) == sorted(tt.data)
    for c in jt.data:
        a, b = np.asarray(jt.data[c]), np.asarray(tt.data[c])
        assert a.dtype == b.dtype, c
        assert a.tobytes() == b.tobytes(), c
    assert {k: d.values() for k, d in jt.dicts.items()} == \
        {k: d.values() for k, d in tt.dicts.items()}
    assert {k: d.sorted for k, d in jt.dicts.items()} == \
        {k: d.sorted for k, d in tt.dicts.items()}
    for c in jt.valid:
        assert np.array_equal(jt.valid[c], tt.valid[c])


@pytest.mark.parametrize("name", TABLES)
def test_table_from_arrays_matches_generated(both, name):
    jt, tt = both[0][name], both[1][name]
    built = table_from_arrays(
        name, _fields(jt), {c: np.asarray(a) for c, a in jt.data.items()},
        {c: d.values() for c, d in jt.dicts.items()},
        {c: np.asarray(v) for c, v in jt.valid.items()},
    )
    assert _fields(built) == _fields(tt)
    for c in tt.data:
        assert built.data[c].tobytes() == tt.data[c].tobytes()
    assert {k: (d.values(), d.sorted) for k, d in built.dicts.items()} == \
        {k: (d.values(), d.sorted) for k, d in tt.dicts.items()}


def _host_equal(a, b, what):
    assert sorted(a) == sorted(b)
    for c in a:
        x, y = a[c], b[c]
        if isinstance(x, list):
            assert x == list(y), f"{what}.{c}"
        else:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, f"{what}.{c}"
            np.testing.assert_array_equal(y, x, err_msg=f"{what}.{c}")


@pytest.mark.parametrize("name", TABLES)
def test_batch_round_trip_matches_jax(both, name):
    jt, tt = both[0][name], both[1][name]
    jb = j_make(jt.data, jt.schema, jt.dicts, valid=jt.valid)
    tb = t_make(tt.data, tt.schema, tt.dicts, valid=tt.valid, device="cpu")
    assert jb.capacity == tb.capacity
    assert int(jb.nrows) == int(tb.nrows)
    np.testing.assert_array_equal(tb.sel.numpy(), np.asarray(jb.sel))
    _host_equal(j_to_host(jb), t_to_host(tb), name)


def test_batch_with_nulls_and_capacity():
    from oceanbase_tpu.core.dtypes import DataType as JDT, Field as JF, \
        Schema as JS
    from oceanbase_tpu_torch.core.dtypes import DataType as TDT, \
        Field as TF, Schema as TS

    data = {"x": np.array([3, -1, 7], np.int64),
            "y": np.array([150, -25, 0], np.int32)}
    valid = {"x": np.array([True, False, True])}
    js = JS((JF("x", JDT.int64(nullable=True)), JF("y", JDT.decimal(9, 2))))
    ts = TS((TF("x", TDT.int64(nullable=True)), TF("y", TDT.decimal(9, 2))))
    jb = j_make(data, js, valid=valid, capacity=2048)
    tb = t_make(data, ts, valid=valid, capacity=2048, device="cpu")
    assert tb.capacity == 2048 and tb.cols["x"].dtype.itemsize == 8
    _host_equal(j_to_host(jb), t_to_host(tb), "nulls")
