"""The direct GROUP BY past 64 packed slots (K2).

The executor (the JAX package's rule) takes the direct path when the
product of the keys' true domains, times 2 for each nullable key, is at
most 64. pack_keys gives each key whole bits, so the packed slots can be
many more: 5 x 3 x 3 = 45 packs into 128, and each key of domain 1 takes a
bit of its own. K2 reduces over the dense mixed-radix slots (at most 64)
and its final pass lays the groups out in the packed slots, so the port
returns the JAX package's rows in the JAX package's slot order.

- the statement that raised (`K2 domain 128 outside 1..64`) as a twin of
  the JAX Session, with the direct path's domains recorded at the call;
- two dictionary keys of 5 values, one nullable (50 dense slots, 128
  packed), and a key of domain 1 beside others;
- `groupby_slots_plain` against the JAX package's `groupby_direct` of the
  packed key at packed domains of 65 to 256, and the layout K2's final
  pass decodes (`k2_layout`, `k2_spread`) against pack_keys's bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceanbase_tpu.core.dictionary import Dictionary as JDict
from oceanbase_tpu.core.dtypes import DataType as JDT
from oceanbase_tpu.core.dtypes import Field as JField
from oceanbase_tpu.core.dtypes import Schema as JSchema
from oceanbase_tpu.core.table import Table as JTable
from oceanbase_tpu.engine.session import Session as JSession
from oceanbase_tpu.models.tpch import datagen as JD
from oceanbase_tpu.ops.hashagg import groupby_direct as j_groupby
from oceanbase_tpu.ops.hashing import pack_keys as j_pack
from oceanbase_tpu_torch import kernels as K
from oceanbase_tpu_torch.core.table import table_from_arrays
from oceanbase_tpu_torch.engine import executor as TX
from oceanbase_tpu_torch.engine.session import Session as TSession
from oceanbase_tpu_torch.models.tpch import datagen as TD
from oceanbase_tpu_torch.models.tpch import sql_suite as TS
from oceanbase_tpu_torch.ops.hashing import dense_keys
from tests.torch_twins import check_twin

SEED = 19920101
# the statement of the open fault: 5 x 3 x 3 = 45 groups, 128 packed slots
STMT_C1 = ("select o_orderpriority, o_orderstatus, l_returnflag, count(*) "
           "as n from orders, lineitem where o_orderkey = l_orderkey group by "
           "o_orderpriority, o_orderstatus, l_returnflag")


def _direct_domains(monkeypatch):
    """Record the key domains of every direct group-by the port runs."""
    seen = []
    orig = TX.groupby_direct

    def counted(keys, domains, *a, **kw):
        seen.append(list(domains))
        return orig(keys, domains, *a, **kw)

    monkeypatch.setattr(TX, "groupby_direct", counted)
    return seen


def test_statement_past_64_packed_slots(monkeypatch):
    """The open fault's statement at SF 0.003: 35 rows, equal to the JAX
    Session's, through the direct path at 45 dense / 128 packed slots."""
    js = JSession(JD.generate(sf=0.003, seed=SEED))
    ts = TSession(TD.generate(sf=0.003, seed=SEED),
                  unique_keys=TS.UNIQUE_KEYS, device="cpu")
    seen = _direct_domains(monkeypatch)
    rows = check_twin(js, ts, STMT_C1 + " order by o_orderpriority, "
                      "o_orderstatus, l_returnflag")
    assert len(rows) == 35
    assert [5, 3, 3] in seen
    dense, slots, _k, _z = K.k2_layout([5, 3, 3])
    assert (dense, slots) == (45, 128)


def _dict_table(C, name, n, seed):
    """a: 5 values, b: 5 values (nullable), c: 3 values, one: 1 value,
    v: int64 values; about a fifth of b NULL."""
    rng = np.random.default_rng(seed)
    data = {"a": rng.integers(0, 5, n).astype(np.int32),
            "b": rng.integers(0, 5, n).astype(np.int32),
            "c": rng.integers(0, 3, n).astype(np.int32),
            "one": np.zeros(n, np.int32),
            "v": rng.integers(-10**6, 10**6, n).astype(np.int64)}
    valid = {"b": rng.random(n) > 0.2}
    data["b"][~valid["b"]] = 0
    words = {"a": [f"a{i}" for i in range(5)],
             "b": [f"b{i}" for i in range(5)],
             "c": [f"c{i}" for i in range(3)], "one": ["only"]}
    if C == "jax":
        schema = JSchema((JField("a", JDT.varchar()),
                          JField("b", JDT.varchar(nullable=True)),
                          JField("c", JDT.varchar()),
                          JField("one", JDT.varchar()),
                          JField("v", JDT.int64())))
        return JTable(name, schema, dict(data),
                      {k: JDict(w, sorted_=True) for k, w in words.items()},
                      dict(valid))
    return table_from_arrays(
        name, [("a", "varchar", 0, 0, False), ("b", "varchar", 0, 0, True),
               ("c", "varchar", 0, 0, False), ("one", "varchar", 0, 0, False),
               ("v", "int64", 0, 0, False)], data, words, valid)


@pytest.fixture(scope="module")
def dict_engines():
    js = JSession({"t": _dict_table("jax", "t", 3000, 7)})
    ts = TSession({"t": _dict_table("torch", "t", 3000, 7)}, device="cpu")
    return js, ts


@pytest.mark.parametrize("keys,domains,groups", [
    # 5 x (5 + NULL plane): 50 dense slots, 3 + 4 bits = 128 packed
    ("a, b", [5, 5, 2], 30),
    # a key of domain 1 beside others: its bit is always 0
    ("one, a, b", [1, 5, 5, 2], 30),
    ("a, one, b", [5, 1, 5, 2], 30),
])
def test_dictionary_keys_past_64_packed_slots(dict_engines, monkeypatch,
                                              keys, domains, groups):
    js, ts = dict_engines
    seen = _direct_domains(monkeypatch)
    rows = check_twin(js, ts, f"select {keys}, count(*) as n, sum(v) as s, "
                      f"min(v) as lo, max(v) as hi from t group by {keys} "
                      f"order by {keys}")
    assert seen and seen[0] == domains
    dense, slots, _k, _z = K.k2_layout(domains)
    assert dense <= 64 < slots
    assert len(rows) == groups


def _packed_cases():
    # (key domains) whose packed slots run from 65 to 256
    return [[5, 3, 3], [5, 5, 2], [3, 3, 3, 2], [17, 3], [7, 9],
            [1, 5, 3, 2], [5, 1, 1, 3], [5, 1, 5, 2], [65], [2] * 7]


@pytest.mark.parametrize("domains", _packed_cases())
def test_plain_against_jax_groupby_direct(domains):
    """groupby_slots_plain over the dense slots equals the JAX package's
    groupby_direct over the packed key, slot for slot (used flags, counts,
    sums, min and max of int64, int32 and float64 values, empty slots'
    identities included)."""
    dense, slots, _k, _z = K.k2_layout(domains)
    assert 64 < slots <= 256
    rng = np.random.default_rng(dense * 1000 + slots)
    n = 2000
    cols = [rng.integers(0, d, n).astype(np.int32) for d in domains]
    mask = rng.random(n) < 0.7
    ops = ["count", "sum", "min", "max", "sum"]
    vals = [None, rng.integers(-2**40, 2**40, n),
            rng.integers(-2**31, 2**31, n).astype(np.int32),
            rng.integers(-2**31, 2**31, n).astype(np.int32),
            rng.integers(-10**6, 10**6, n) / 8.0]
    packed, space = j_pack([jnp.asarray(c) for c in cols], domains)
    assert space == slots
    ju, ja = j_groupby(packed, space, jnp.asarray(mask), ops,
                       [None if v is None else jnp.asarray(v) for v in vals])
    tkeys = dense_keys([torch.from_numpy(c) for c in cols], domains)
    tm = torch.from_numpy(mask)
    got = K.groupby_slots_plain(tkeys, domains, [("count", None, tm)] + [
        (op, None if v is None else torch.from_numpy(np.asarray(v)), tm)
        for op, v in zip(ops, vals)])
    assert np.array_equal(np.asarray(ju), got[0].numpy() > 0)
    for op, a, b in zip(ops, ja, got[1:]):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape == (slots,), op
        assert np.array_equal(a, b), (domains, op)


@pytest.mark.parametrize("domains", _packed_cases() + [[8], [64], [6, 2]])
def test_layout_matches_pack_keys(domains):
    """k2_spread maps every packed slot to the dense slot of the key
    fields pack_keys put in its bits, and -1 where a field lies outside
    its domain; dense_keys and pack_keys agree row for row through it."""
    dense, slots, _k, _z = K.k2_layout(domains)
    spread = K.k2_spread(domains)
    assert len(spread) == slots
    assert sorted(d for d in spread if d >= 0) == list(range(dense))
    fields = np.stack(np.meshgrid(*[np.arange(d) for d in domains],
                                  indexing="ij"), -1).reshape(-1, len(domains))
    cols = [torch.from_numpy(fields[:, i].astype(np.int32))
            for i in range(len(domains))]
    packed, space = j_pack([jnp.asarray(c.numpy()) for c in cols], domains)
    dk = dense_keys(cols, domains).numpy()
    assert space == slots
    assert np.array_equal(np.asarray(spread)[np.asarray(packed)], dk)
