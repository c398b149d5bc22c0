"""Equi-joins on float keys in the port, against the numpy oracle and the
JAX Session.

Two tables from numpy.random.default_rng: a (300 rows, seed 1) and b
(200 rows, seed 2); f DOUBLE = integers(0, 40) / 4 - 3, k BIGINT =
integers(0, 5), v BIGINT = integers(0, 1000), g FLOAT = integers(0, 30)
/ 2. The port joins a float key by its value: one float key on the
injective image of its float64 bits (-0.0 as +0.0), a key pair of a
float and another type as float64, several keys through K12's hash of
the same images with every pair verified by value, a NaN key matching
nothing.

The two-key statements are twins of the JAX Session, which filters
multi-key pairs exactly. For one key the JAX package hashes a float by
truncating it to uint64 and gives wrong counts; those statements are held
to numpy, and the JAX count is recorded beside each (JAX_WRONG) and
checked to still differ, so the reference's fault stays in view.
"""

import numpy as np
import pytest
import torch

from oceanbase_tpu.core.dtypes import DataType as JDT, Field as JField
from oceanbase_tpu.core.dtypes import Schema as JSchema
from oceanbase_tpu.core.table import Table as JTable
from oceanbase_tpu.engine.session import Session as JSession
from oceanbase_tpu.ops.hashing import hash_combine as j_hash_combine
from oceanbase_tpu_torch import kernels as K
from oceanbase_tpu_torch.core.table import table_from_arrays
from oceanbase_tpu_torch.engine.session import Session as TSession
from oceanbase_tpu_torch.ops.join import join_keys64, key_live
from tests.torch_twins import check_twin

FIELDS = (("f", "float64"), ("k", "int64"), ("v", "int64"),
          ("g", "float32"))


def _data(seed: int, n: int, extra=None) -> dict:
    r = np.random.default_rng(seed)
    d = {"f": r.integers(0, 40, n) / 4 - 3,
         "k": r.integers(0, 5, n).astype(np.int64),
         "v": r.integers(0, 1000, n).astype(np.int64),
         "g": (r.integers(0, 30, n) / 2).astype(np.float32)}
    if extra is not None:
        extra(d)
    return d


def _sessions(tables: dict):
    jt, tt = {}, {}
    for name, data in tables.items():
        jt[name] = JTable.from_pydict(
            name, JSchema(tuple(JField(c, getattr(JDT, k)())
                                for c, k in FIELDS)), data)
        tt[name] = table_from_arrays(
            name, [(c, k, 0, 0, False) for c, k in FIELDS], data)
    return JSession(jt), TSession(tt, device="cpu")


@pytest.fixture(scope="module")
def ab():
    a, b = _data(1, 300), _data(2, 200)
    js, ts = _sessions({"a": a, "b": b})
    return a, b, js, ts


def _signed_zeros(d):
    # f's 0.0 rows of every other row become -0.0; two rows become NaN
    z = np.flatnonzero(d["f"] == 0.0)
    d["f"][z[::2]] = -0.0
    d["f"][[3, 7]] = np.nan
    d["g"][[5]] = np.nan


@pytest.fixture(scope="module")
def ab_edges():
    a, b = _data(1, 300, _signed_zeros), _data(2, 200, _signed_zeros)
    js, ts = _sessions({"a": a, "b": b})
    return a, b, js, ts


def _pairs(a, b, lk, rk):
    """(left row, right row) of every matching pair, by value (numpy ==:
    NaN matches nothing, -0.0 meets 0.0, an int meets its float)."""
    eq = np.ones((len(a[lk[0]]), len(b[rk[0]])), dtype=bool)
    for x, y in zip(lk, rk):
        eq &= a[x].astype(np.float64)[:, None] == b[y].astype(np.float64)[None, :]
    return np.nonzero(eq)


def _counts(a, b, lk, rk):
    """The numpy oracle's count(*) for inner, LEFT, RIGHT and FULL."""
    li, ri = _pairs(a, b, lk, rk)
    na, nb = len(a[lk[0]]), len(b[rk[0]])
    lu = na - len(np.unique(li))
    ru = nb - len(np.unique(ri))
    return {"inner": len(li), "left": len(li) + lu, "right": len(li) + ru,
            "full": len(li) + lu + ru}


JOIN_SQL = {"inner": "select count(*) from a, b where {on}",
            "left": "select count(*) from a left join b on {on}",
            "right": "select count(*) from a right join b on {on}",
            "full": "select count(*) from a full join b on {on}"}

# one key: (condition, left keys, right keys), the JAX Session's inner
# count beside (ROADMAP.md, fault C 1: numpy 1499, 1978 and 1638)
SINGLE = {
    "double": ("a.f = b.f", ["f"], ["f"]),
    "float": ("a.g = b.g", ["g"], ["g"]),
    "bigint_double": ("a.k = b.f", ["k"], ["f"]),
    "double_float": ("a.f = b.g", ["f"], ["g"]),
}
JAX_WRONG = {"double": 12210, "float": 4048, "bigint_double": 0}


@pytest.mark.parametrize("kind", list(JOIN_SQL))
@pytest.mark.parametrize("case", list(SINGLE))
def test_single_float_key_equals_numpy(ab, case, kind):
    a, b, js, ts = ab
    on, lk, rk = SINGLE[case]
    want = _counts(a, b, lk, rk)[kind]
    got = ts.sql(JOIN_SQL[kind].format(on=on)).rows()[0][0]
    assert got == want, (case, kind, got, want)
    if kind == "inner" and case in JAX_WRONG:
        assert want == {"double": 1499, "float": 1978,
                        "bigint_double": 1638}[case]
        jgot = js.sql(JOIN_SQL[kind].format(on=on)).rows()[0][0]
        assert jgot == JAX_WRONG[case] != want


@pytest.mark.parametrize("kind", list(JOIN_SQL))
@pytest.mark.parametrize("case", ["double", "float", "bigint_double"])
def test_signed_zero_and_nan_keys(ab_edges, case, kind):
    """-0.0 meets 0.0 and a NaN key matches nothing, in every join kind
    (NaN rows of an outer join's preserved side stay, unmatched)."""
    a, b, js, ts = ab_edges
    on, lk, rk = SINGLE[case]
    want = _counts(a, b, lk, rk)[kind]
    got = ts.sql(JOIN_SQL[kind].format(on=on)).rows()[0][0]
    assert got == want, (case, kind, got, want)


def test_single_key_sums_equal_numpy(ab_edges):
    a, b, js, ts = ab_edges
    li, ri = _pairs(a, b, ["f"], ["f"])
    got = ts.sql("select count(*), sum(a.v), sum(b.v) from a, b "
                 "where a.f = b.f").rows()[0]
    assert tuple(got) == (len(li), int(a["v"][li].sum()),
                          int(b["v"][ri].sum()))


TWO_KEY = [
    "select count(*), sum(a.v) from a, b where a.f = b.f and a.k = b.k",
    "select a.k, count(*) from a, b where a.g = b.g and a.k = b.k "
    "group by a.k order by a.k",
    "select count(*), sum(b.v) from a left join b on a.f = b.f "
    "and a.k = b.k",
    "select count(*) from a right join b on a.g = b.g and a.k = b.k",
    "select count(*), sum(a.v) from a full join b on a.f = b.f "
    "and a.k = b.k",
]


@pytest.mark.parametrize("sql", TWO_KEY)
def test_two_key_twins(ab, sql):
    a, b, js, ts = ab
    check_twin(js, ts, sql)


def test_two_key_values_equal_numpy(ab):
    a, b, js, ts = ab
    li, _ri = _pairs(a, b, ["f", "k"], ["f", "k"])
    got = ts.sql(TWO_KEY[0]).rows()[0]
    assert tuple(got) == (341, 164766) == (len(li), int(a["v"][li].sum()))
    rows = ts.sql(TWO_KEY[1]).rows()
    assert [r[1] for r in rows] == [88, 63, 56, 97, 70]


def test_mixed_two_keys_equal_numpy(ab_edges):
    """BIGINT = DOUBLE beside FLOAT = DOUBLE: both pairs compare as
    float64 before K12 hashes them, and the pairs are verified by
    value."""
    a, b, js, ts = ab_edges
    li, _ri = _pairs(a, b, ["k", "g"], ["f", "f"])
    got = ts.sql("select count(*), sum(a.v) from a, b "
                 "where a.k = b.f and a.g = b.f").rows()[0]
    assert tuple(got) == (len(li), int(a["v"][li].sum()))


def test_float_semi_and_anti_equal_numpy(ab_edges):
    a, b, js, ts = ab_edges
    hit = np.isin(a["f"], b["f"])  # NaN is in nothing; -0.0 in 0.0
    got = ts.sql("select count(*) from a where f in (select f from b)")
    assert got.rows()[0][0] == int(hit.sum())
    got = ts.sql("select count(*) from a where k in (select f from b)")
    assert got.rows()[0][0] == int(np.isin(a["k"].astype(np.float64),
                                           b["f"]).sum())


def test_join_keys64_of_floats():
    """One float key: the image of its float64 bits, -0.0 as +0.0;
    float32 widened exactly; unequal values, unequal images."""
    x = torch.tensor([1.5, -0.0, 0.0, -2.25, 3.0], dtype=torch.float64)
    img = join_keys64([x])
    assert img.dtype == torch.int64
    assert img[1] == img[2] == 0
    assert len(set(img.tolist())) == 4
    f32 = torch.tensor([1.5, -0.0, -2.25, 0.1], dtype=torch.float32)
    assert torch.equal(join_keys64([f32]),
                       join_keys64([f32.to(torch.float64)]))
    m = key_live([x, torch.tensor([1.0, float("nan"), 2.0, 3.0, 4.0])],
                 torch.ones(5, dtype=torch.bool))
    assert m.tolist() == [True, False, True, True, True]


def test_k12_plain_hashes_float_images():
    """K12's plain version hashes a float column's value image; on
    integer columns it stays bit-equal to the JAX hash_combine."""
    rng = np.random.default_rng(12)
    ints = rng.integers(-1000, 1000, 64).astype(np.int64)
    f = rng.integers(-8, 8, 64) / 4
    f[::7] = -0.0
    got = K.hash_columns_plain([torch.from_numpy(ints),
                                torch.from_numpy(f)])
    want = K.hash_columns_plain([torch.from_numpy(ints),
                                 K.float_key_image(torch.from_numpy(f))])
    assert torch.equal(got, want)
    zero = K.hash_columns_plain([torch.tensor([0.0, -0.0]),
                                 torch.tensor([1, 1])])
    assert zero[0] == zero[1]
    ref = np.asarray(j_hash_combine([ints, ints[::-1].copy()])).view(
        np.int64)
    assert np.array_equal(
        K.hash_columns_plain([torch.from_numpy(ints),
                              torch.from_numpy(ints[::-1].copy())]).numpy(),
        ref)
