"""Optimizer statistics: per-column NDV / min-max / equi-height histograms.

Reference surface: src/share/stat (dbms_stats collection, ObOptColumnStat
histograms, NDV) feeding the cost-based optimizer's selectivity and join
ordering (src/sql/optimizer/ob_join_order.h, ob_opt_selectivity.cpp). The
reference collects via full/sampled table scans into __all_*_stat inner
tables; the rebuild collects directly from catalog snapshot Tables (whose
columns are already dense numpy arrays — a "scan" is vectorized numpy) and
caches per snapshot object.

Everything is computed in the STORAGE domain (decimals as scaled ints,
dates as day numbers, VARCHAR as sorted-dictionary codes). Sorted dict
codes order like their strings, so range selectivity on codes is string
range selectivity — the global-dictionary dividend the engine design
already pays for.

Estimation entry points:
  * `TableStats.selectivity(expr, table)` — fraction of rows satisfying a
    pushed-filter conjunct tree (Compare/Between/InList/IsNull/BoolOp/Not).
  * `ColumnStats.eq_frac` / `range_frac` — primitives (histogram based).
  * `StatsManager` — per-catalog cache keyed on snapshot identity.

Unknown expression shapes fall back to the classic constants (eq 1/ndv,
range 1/4, unknown 1/4) so estimates degrade, never fail.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

N_BUCKETS = 64
SAMPLE_CAP = 1 << 16

_DEFAULT_SEL = 0.25


@dataclass
class ColumnStats:
    ndv: float
    vmin: float
    vmax: float
    null_frac: float
    # equi-height histogram: N_BUCKETS+1 edges over the non-null values
    # (edges[i] = quantile i/N). None for empty columns.
    edges: np.ndarray | None = None

    # ---- primitives --------------------------------------------------
    def _eq_nonnull(self, v: float) -> float:
        """P(col = v | col not null)."""
        if self.ndv <= 0 or v < self.vmin or v > self.vmax:
            return 0.0
        return 1.0 / max(self.ndv, 1.0)

    def eq_frac(self, v: float) -> float:
        return self._eq_nonnull(v) * (1.0 - self.null_frac)

    def le_frac(self, v: float) -> float:
        """P(col <= v | col not null), via histogram interpolation."""
        if self.edges is None:
            return _DEFAULT_SEL
        e = self.edges
        if v < e[0]:
            return 0.0
        if v >= e[-1]:
            return 1.0
        # position among bucket edges + linear interpolation inside bucket
        i = int(np.searchsorted(e, v, side="right")) - 1
        i = min(i, len(e) - 2)
        lo, hi = float(e[i]), float(e[i + 1])
        frac_in = 0.5 if hi <= lo else (v - lo) / (hi - lo)
        return (i + frac_in) / (len(e) - 1)

    def range_frac(self, lo: float | None, hi: float | None,
                   lo_inc: bool = True, hi_inc: bool = True) -> float:
        """P(lo <op> col <op> hi) over ALL rows (nulls fail the filter).
        Exclusive bounds subtract one value's probability mass — essential
        on discrete domains (dict codes, dates, small ints)."""
        if hi is None:
            p_hi = 1.0
        else:
            p_hi = self.le_frac(hi) - (
                self._eq_nonnull(hi) if not hi_inc else 0.0
            )
        if lo is None:
            p_lo = 0.0
        else:
            p_lo = self.le_frac(lo) - (
                self._eq_nonnull(lo) if lo_inc else 0.0
            )
        sel = min(max(p_hi - p_lo, 0.0), 1.0)
        return sel * (1.0 - self.null_frac)


@dataclass
class TableStats:
    nrows: int
    cols: dict[str, ColumnStats] = field(default_factory=dict)

    # ---- expression selectivity --------------------------------------
    def selectivity(self, expr, table) -> float:
        """Estimated fraction of rows satisfying `expr` (a filter tree).
        `table` is the core Table (for dictionaries + schema)."""
        from ..expr import ir as E

        def col_of(e):
            if isinstance(e, E.ColRef):
                base = e.name.split(".", 1)[-1]
                return base if base in self.cols else None
            return None

        def lit_storage(value, colname):
            """Literal -> storage-domain float (None if unconvertible)."""
            from ..core.dtypes import TypeKind
            from ..expr.compile import bind_value

            if value is None:
                return None
            try:
                dt = table.schema[colname]
            except KeyError:
                return None
            if dt.kind is TypeKind.VARCHAR:
                import bisect

                d = table.dicts.get(colname)
                if d is None or not isinstance(value, str):
                    return None
                # sorted dicts: rank of the string = code-domain position
                return float(bisect.bisect_left(d.values(), value))
            try:
                return float(bind_value(value, dt))
            except (TypeError, ValueError):
                return None

        def sel(e) -> float:
            if isinstance(e, E.BoolOp):
                parts = [sel(a) for a in e.args]
                if e.op == "and":
                    out = 1.0
                    for p in parts:
                        out *= p
                    return out
                out = 1.0
                for p in parts:
                    out *= (1.0 - p)
                return 1.0 - out
            if isinstance(e, E.Not):
                return max(0.0, 1.0 - sel(e.arg))
            if isinstance(e, E.IsNull):
                c = col_of(e.arg)
                if c is None:
                    return _DEFAULT_SEL
                nf = self.cols[c].null_frac
                return (1.0 - nf) if e.negated else nf
            if isinstance(e, E.Between):
                c = col_of(e.arg)
                if c is None:
                    return _DEFAULT_SEL
                lo = lit_storage(e.low.value, c) if isinstance(e.low, E.Literal) else None
                hi = lit_storage(e.high.value, c) if isinstance(e.high, E.Literal) else None
                if lo is None and hi is None:
                    return _DEFAULT_SEL
                s = self.cols[c].range_frac(lo, hi)
                return (1.0 - s) if e.negated else s
            if isinstance(e, E.InList):
                c = col_of(e.arg)
                if c is None:
                    return _DEFAULT_SEL
                cs = self.cols[c]
                s = min(
                    len(e.values) * (1.0 - cs.null_frac) / max(cs.ndv, 1.0),
                    1.0,
                )
                return (1.0 - s) if e.negated else s
            if isinstance(e, E.Compare):
                l, r = e.left, e.right
                op = e.op
                if isinstance(l, E.Literal) and not isinstance(r, E.Literal):
                    flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
                    l, r = r, l
                    op = flip.get(op, op)
                c = col_of(l)
                if c is None or not isinstance(r, E.Literal):
                    return _DEFAULT_SEL
                v = lit_storage(r.value, c)
                if v is None:
                    return _DEFAULT_SEL
                cs = self.cols[c]
                if op in ("=", "=="):
                    return cs.eq_frac(v)
                if op in ("!=", "<>"):
                    return max(0.0, (1.0 - cs.null_frac) - cs.eq_frac(v))
                if op == "<":
                    return cs.range_frac(None, v, hi_inc=False)
                if op == "<=":
                    return cs.range_frac(None, v)
                if op == ">":
                    return max(
                        0.0, (1.0 - cs.null_frac) - cs.range_frac(None, v)
                    )
                if op == ">=":
                    return max(
                        0.0,
                        (1.0 - cs.null_frac) - cs.range_frac(None, v, hi_inc=False),
                    )
                return _DEFAULT_SEL
            # LIKE / Func / Case / arithmetic comparisons: no model
            return _DEFAULT_SEL

        s = sel(expr)
        return float(min(max(s, 0.0), 1.0))

    def ndv_of(self, colname: str) -> float | None:
        base = colname.split(".", 1)[-1]
        cs = self.cols.get(base)
        return cs.ndv if cs is not None else None


def collect_table_stats(table) -> TableStats:
    """One vectorized pass per column; big columns are stride-sampled to
    SAMPLE_CAP rows for NDV/histograms (min/max always exact)."""
    nrows = table.nrows
    ts = TableStats(nrows)
    if nrows == 0:
        return ts
    for f in table.schema.fields:
        arr = table.data.get(f.name)
        if arr is None or arr.dtype.kind not in "iufb":
            continue
        arr = np.asarray(arr)
        valid = table.valid.get(f.name)
        if valid is not None:
            nn = arr[np.asarray(valid, dtype=bool)]
        else:
            nn = arr
        n_nonnull = len(nn)
        if n_nonnull == 0:
            ts.cols[f.name] = ColumnStats(0.0, 0.0, 0.0, 1.0, None)
            continue
        vmin = float(nn.min())
        vmax = float(nn.max())
        if n_nonnull > SAMPLE_CAP:
            step = n_nonnull // SAMPLE_CAP
            sample = nn[:: step]
        else:
            sample = nn
        d = len(np.unique(sample))
        if len(sample) == n_nonnull:
            ndv = float(d)
        elif d >= 0.1 * len(sample):
            # near-unique in the sample: scale linearly
            ndv = min(float(n_nonnull), d * (n_nonnull / len(sample)))
        else:
            # saturated: the sample already saw (almost) every value
            ndv = float(d)
        qs = np.linspace(0.0, 1.0, N_BUCKETS + 1)
        edges = np.quantile(sample.astype(np.float64), qs)
        null_frac = 1.0 - n_nonnull / nrows
        ts.cols[f.name] = ColumnStats(ndv, vmin, vmax, null_frac, edges)
    return ts


class StatsManager:
    """Per-catalog stats cache: recollects when a table's snapshot object
    changes (refresh installs a NEW Table per data version)."""

    def __init__(self, catalog):
        self.catalog = catalog
        self._cache: dict[str, tuple[object, TableStats]] = {}

    def table_stats(self, name: str) -> TableStats | None:
        t = self.catalog.get(name)
        if t is None:
            return None
        is_priv = getattr(self.catalog, "is_private", None)
        if is_priv is not None and is_priv(name):
            # tx-private view: per-statement snapshot objects would force a
            # recollection every statement AND evict the committed entry.
            # Slightly-stale committed stats are fine for estimation.
            hit = self._cache.get(name)
            return hit[1] if hit is not None else None
        hit = self._cache.get(name)
        if hit is not None and hit[0] is t:
            return hit[1]
        ts = collect_table_stats(t)
        # hold the Table itself: identity compare is exact, and the held
        # reference prevents id() reuse from serving stale stats
        self._cache[name] = (t, ts)
        return ts

    def invalidate(self, name: str) -> None:
        self._cache.pop(name, None)
