"""Shared helpers of the statement-level twin tests: the same SQL through
the JAX Session and the port's Session(device="cpu") over tables made by
the two packages' own generators from one seed.

Results must hold the same rows in the same order: every column in the
storage domain (integers, scaled decimals, dates, dictionary codes,
validity) exactly, float columns to rel 1e-12 (the two backends may sum
in different orders), and every decoded row likewise.
"""

import numpy as np
import pytest

from oceanbase_tpu.core.column import batch_rows_storage as j_storage

FLOAT_RTOL = 1e-12


def rows_equal(jrows, trows, what):
    assert len(jrows) == len(trows), f"{what}: {len(jrows)} vs {len(trows)}"
    for i, (a, b) in enumerate(zip(jrows, trows)):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            if x is None or y is None:
                assert x is None and y is None, f"{what} row {i}: {x} vs {y}"
            elif isinstance(x, (float, np.floating)):
                assert isinstance(y, (float, np.floating)), what
                if np.isnan(x):
                    assert np.isnan(y), f"{what} row {i}"
                else:
                    assert y == pytest.approx(x, rel=FLOAT_RTOL, abs=0.0), \
                        f"{what} row {i}: {x} vs {y}"
            else:
                assert x == y, f"{what} row {i}: {x} vs {y}"


def storage_equal(jcols, tcols, what):
    assert list(jcols) == list(tcols), what
    for c in jcols:
        j, t = np.asarray(jcols[c]), np.asarray(tcols[c])
        assert j.shape == t.shape, f"{what} {c}: {j.shape} vs {t.shape}"
        if j.dtype.kind == "f":
            np.testing.assert_allclose(t, j, rtol=FLOAT_RTOL, atol=0.0,
                                       equal_nan=True, err_msg=f"{what} {c}")
        else:
            assert np.array_equal(j, t), f"{what} {c}"


def check_twin(js, ts, sql, min_rows=1):
    """Run `sql` through both sessions and hold the port to the
    reference; returns the port's rows."""
    jr = js.sql(sql)
    tr = ts.sql(sql)
    names = list(jr.names)
    assert names == list(tr.names), (names, tr.names)
    jrows, trows = jr.rows(), tr.rows()
    rows_equal(jrows, trows, sql[:60])
    assert len(trows) >= min_rows, f"{sql[:60]}: {len(trows)} rows"
    cursor = getattr(jr, "_cursor", None)
    if cursor is not None:
        assert jr.nrows == len(jrows)
        storage_equal(j_storage(cursor._out, names), tr.storage_columns(),
                      sql[:60])
    return trows
