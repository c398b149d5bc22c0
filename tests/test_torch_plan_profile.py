"""Operator-level plan telemetry of the port against the JAX package's:
twins of tests/test_plan_profile.py (every test but the plan-artifact
one: the port has no artifact store yet).

The profiled run executes a prepared plan as per-operator stages timed
on their own (engine/plan_profile.py: CUDA events on the card, the host
clock on the CPU); the rows it serves must equal the plain program's,
and the JAX Database's, on the warm query mix. The host-only halves (the
sampling cadence, the calibration store, the sentinel's misestimate
rule, the EXPLAIN ANALYZE annotator) run the same inputs through both
packages' modules.
"""

import json

import pytest

import oceanbase_tpu.engine.plan_profile as JPP
import oceanbase_tpu.server.sentinel as JSEN
import oceanbase_tpu.sql.explain as JEX
import oceanbase_tpu_torch.engine.plan_profile as TPP
import oceanbase_tpu_torch.server.sentinel as TSEN
import oceanbase_tpu_torch.sql.explain as TEX
from oceanbase_tpu.models.tpch import datagen as jdatagen
from oceanbase_tpu.models.tpch.sql_suite import QUERIES
from oceanbase_tpu.models.tpch.sql_suite import UNIQUE_KEYS as J_KEYS
from oceanbase_tpu_torch.models.tpch import datagen as tdatagen
from oceanbase_tpu_torch.models.tpch.sql_suite import UNIQUE_KEYS as T_KEYS
from oceanbase_tpu_torch.sql import parser as P
from torch_twins import TwinDatabase, rows_equal

JOIN_Q = ("select c_mktsegment, count(*) as n from customer, orders "
          "where c_custkey = o_custkey "
          "group by c_mktsegment order by c_mktsegment")

MIX = {"q1": QUERIES[1], "q6": QUERIES[6], "q3": QUERIES[3],
       "join": JOIN_Q}

PACKAGES = (JPP, TPP)


@pytest.fixture(scope="module")
def db():
    d = TwinDatabase.build(n_nodes=1, n_ls=1,
                           jextra=jdatagen.generate(sf=0.003),
                           textra=tdatagen.generate(sf=0.003))
    for x, keys in ((d.j, J_KEYS), (d.t, T_KEYS)):
        # preloaded benchmark tables carry no DDL primary keys: register
        # their unique keys so the physical fast paths are eligible
        x._unique_keys.update(keys)
        x.engine.executor.unique_keys = x._unique_keys
        x.engine.planner.unique_keys = x._unique_keys
        # the slow-query watermark force-arms profiling: park it out of
        # reach so the cadence here is deterministic
        x.config.set("trace_log_slow_query_watermark", "3600")
    yield d
    d.close()


@pytest.fixture(scope="module")
def fused(db):
    """The plain program's rows for the mix, profiling off."""
    db.both(lambda x: x.config.set("enable_plan_profile", "false"))
    s = db.session()
    out = {name: s.sql(q).rows() for name, q in MIX.items()}
    db.both(lambda x: x.config.set("enable_plan_profile", "true"))
    assert all(out.values())
    return out


def _profiled(db, q):
    """Force a profile of q on both packages; returns the port's rows and
    each package's last operator profile."""
    digest = P.digest_text(q)
    db.both(lambda x: x.plan_profiler.force_next(digest))
    got = db.session().sql(q).rows()
    return got, db.both(lambda x: x.engine.last_op_profile)


@pytest.mark.parametrize("name", list(MIX))
def test_profiled_run_bit_identical_to_fused(db, fused, name):
    got, opps = _profiled(db, MIX[name])
    assert db.t.engine.profile_fallbacks == 0
    for opp in opps:
        assert opp is not None and opp["reason"] == "forced"
        assert opp["samples"], "profiled run yielded no operator samples"
        assert all(smp.device_us >= 0 for smp in opp["samples"])
    rows_equal(fused[name], got, name)
    # the same operators, rows and bytes per node as the JAX stages
    jo, to = opps
    assert [(s.node_id, s.op_kind, s.rows) for s in to["samples"]] == \
        [(s.node_id, s.op_kind, s.rows) for s in jo["samples"]]
    assert to["estimates"] == jo["estimates"]
    assert to["absorbed"] == jo["absorbed"]


@pytest.mark.parametrize("name", list(MIX))
def test_every_plan_node_lands_in_plan_monitor_vt(db, fused, name):
    q = MIX[name]
    digest = P.digest_text(q)
    _got, opps = _profiled(db, q)
    for x, opp in zip((db.j, db.t), opps):
        s = x.session()
        absorbed = set(opp["absorbed"])
        if name == "q3":  # Q3's inner join is absorbed by the clustered agg
            assert absorbed
        n_nodes = len(s.sql("explain " + q).rows())
        vt = s.sql(
            "select query_sql, node_id, op_kind, est_rows, actual_rows, "
            "device_us, executions from __all_virtual_sql_plan_monitor"
        ).rows()
        mine = {int(r[1]): r for r in vt if r[0] == digest and r[1] >= 0}
        assert sorted(mine) == [n for n in range(n_nodes)
                                if n not in absorbed]
        assert all(r[2] for r in mine.values())
        assert sum(r[5] for r in mine.values()) > 0
        assert all(r[6] >= 1 for r in mine.values())


def test_vt_keeps_statement_level_rows(db, fused):
    for x in (db.j, db.t):
        vt = x.session().sql(
            "select node_id, op_kind, executions "
            "from __all_virtual_sql_plan_monitor").rows()
        plan_rows = [r for r in vt if r[0] == -1]
        assert plan_rows and all(r[1] == "" for r in plan_rows)
        assert any(r[2] >= 1 for r in plan_rows)


def test_operator_device_time_reconciles_with_gap_ledger(db, fused):
    q = MIX["q6"]
    for x in (db.j, db.t):
        s = x.session()
        x.plan_profiler.force_next(P.digest_text(q))
        s.sql(q).rows()
        opp = x.engine.last_op_profile
        assert opp is not None
        led = s._gap
        assert led is not None and led.closed
        op_us = sum(smp.device_us for smp in opp["samples"])
        assert op_us <= led.e2e_s * 1e6 * 1.05 + 500.0


# ---- sampling cadence -------------------------------------------------------


@pytest.mark.parametrize("pp_mod", PACKAGES, ids=("jax", "torch"))
def test_sampling_cadence_deterministic(pp_mod):
    pp = pp_mod.PlanProfiler(store=pp_mod.OperatorProfileStore(),
                             sample_every=4)
    got = [pp.decide("d") for _ in range(10)]
    assert got == [None, "first", None, None, "sample",
                   None, None, None, "sample", None]
    pp.force_next("d")
    assert pp.decide("d") == "forced"
    assert pp.decide("d") is None
    assert pp.decide("other") is None
    assert pp.decide("other") == "first"
    pp.enabled = False
    assert pp.decide("d") is None
    pp.enabled = True
    pp.sample_every = 0
    assert all(pp.decide("d") is None for _ in range(5))


def test_config_params_wire_to_profiler(db):
    for x in (db.j, db.t):
        pp = x.plan_profiler
        try:
            x.config.set("ob_plan_profile_sample", "16")
            assert pp.sample_every == 16
            x.config.set("ob_plan_profile_max_digests", "8")
            assert pp.store.max_digests == 8
            x.config.set("enable_plan_profile", "false")
            assert pp.enabled is False
            assert pp.decide("whatever") is None
        finally:
            x.config.set("ob_plan_profile_sample", "64")
            x.config.set("ob_plan_profile_max_digests", "128")
            x.config.set("enable_plan_profile", "true")
        assert pp.enabled and pp.sample_every == 64


# ---- EXPLAIN ANALYZE --------------------------------------------------------


def test_explain_analyze_forces_exactly_one_profile(db, fused):
    q = MIX["q6"]
    for x in (db.j, db.t):
        s = x.session()
        store = x.plan_profiler.store
        before = store.profiles
        lines = [r[0] for r in s.sql("explain analyze " + q).rows()]
        assert store.profiles == before + 1
        ann = [ln for ln in lines if "actual_rows=" in ln]
        assert ann and all("device=" in ln and "miss=" in ln for ln in ann)
        assert any("chip_idle_pct:" in ln for ln in lines)
        plain = [r[0] for r in s.sql("explain " + q).rows()]
        assert store.profiles == before + 1
        assert not any("actual_rows=" in ln for ln in plain)


@pytest.mark.parametrize("mods", ((JPP, JEX), (TPP, TEX)),
                         ids=("jax", "torch"))
def test_explain_analyze_marks_misestimates(mods):
    pp_mod, ex_mod = mods
    lines = ["SCAN t as t", "  FILTER pred"]
    prof = {
        "samples": [
            pp_mod.OpSample(node_id=0, op_kind="Scan", device_us=10.0,
                            rows=800, out_bytes=64),
            pp_mod.OpSample(node_id=1, op_kind="Filter", device_us=5.0,
                            rows=100, out_bytes=8),
        ],
        "estimates": {0: 100, 1: 50},
    }
    out = ex_mod.annotate_plan_lines(lines, prof)
    assert out[0].startswith(">> ")
    assert not out[1].startswith(">> ")
    assert "est_rows=100" in out[0] and "actual_rows=800" in out[0]


def test_explain_analyze_annotates_absorbed_nodes(db, fused):
    for x in (db.j, db.t):
        lines = [r[0] for r in x.session().sql(
            "explain analyze " + MIX["q3"]).rows()]
        ab = [ln for ln in lines if "(absorbed into node" in ln]
        assert len(ab) == 1 and "JOIN" in ab[0]
        assert "actual_rows=" not in ab[0]


# ---- store bound + eviction -------------------------------------------------


def _sample(mod, nid=0, kind="Scan", rows=10, us=5.0):
    return mod.OpSample(node_id=nid, op_kind=kind, device_us=us, rows=rows,
                        out_bytes=rows * 8)


@pytest.mark.parametrize("mod", PACKAGES, ids=("jax", "torch"))
def test_store_bounded_evicts_coldest_digest(mod):
    st = mod.OperatorProfileStore(max_digests=2)
    for i in range(4):
        st.fold(f"d{i}", [_sample(mod)], {0: 10})
    assert len(st.snapshot()["digests"]) == 2
    assert st.evictions == 2
    assert sorted(st.snapshot()["digests"]) == ["d2", "d3"]
    st.fold("d2", [_sample(mod)], {0: 10})
    st.fold("d4", [_sample(mod)], {0: 10})
    assert sorted(st.snapshot()["digests"]) == ["d2", "d4"]
    st.set_max_digests(1)
    assert list(st.snapshot()["digests"]) == ["d4"]


@pytest.mark.parametrize("mod", PACKAGES, ids=("jax", "torch"))
def test_store_records_calibration_pairs(mod):
    st = mod.OperatorProfileStore()
    st.fold("q", [_sample(mod, rows=100),
                  _sample(mod, nid=1, kind="Join:inner", rows=7, us=2.0)],
            {0: 10, 1: 7}, plan_id=3)
    st.fold("q", [_sample(mod, rows=300),
                  _sample(mod, nid=1, kind="Join:inner", rows=7, us=2.0)],
            {0: 10, 1: 7})
    recs = {r["node_id"]: r for r in st.digest_profile("q")}
    assert recs[0]["executions"] == 2
    assert recs[0]["est_rows"] == 10 and recs[0]["avg_rows"] == 200.0
    assert recs[0]["miss_factor"] == mod.miss_factor(10, 200.0) == 20.0
    assert recs[0]["max_miss"] == 30.0
    assert recs[1]["miss_factor"] == 1.0
    assert recs[1]["plan_id"] == 3
    snap = st.snapshot()
    assert json.loads(json.dumps(snap)) == snap


# ---- workload snapshots + sentinel ------------------------------------------


def _rec(execs, rows, us, est, kind="Join:inner"):
    return {"executions": execs, "rows": rows, "device_us": us,
            "est_rows": est, "avg_rows": rows / execs if execs else 0.0,
            "op_kind": kind}


def _snap(snap_id, digests):
    return {"snap_id": snap_id, "ts": float(snap_id), "summary": [],
            "sysstat": {}, "plan_profile": {"digests": digests}}


def test_snapshot_embeds_plan_profile(db, fused):
    for x in (db.j, db.t):
        snap = x.workload.take(x)
        assert "plan_profile" in snap
        assert snap["plan_profile"]["digests"]


@pytest.mark.parametrize("sen", (JSEN, TSEN), ids=("jax", "torch"))
def test_misestimate_rule_fires_once_and_grades_severity(sen):
    first = _snap(1, {})
    last = _snap(2, {"q": {
        "2": _rec(6, 1200, 9000.0, est=10),
        "3": _rec(6, 60, 100.0, est=10, kind="Scan"),
    }})
    alerts = [a for a in sen.evaluate_window(first, last)
              if a["rule"] == "cardinality_misestimate"]
    assert len(alerts) == 1
    a = alerts[0]
    assert a["severity"] == "critical"
    assert a["key"] == "q#2"
    assert a["evidence"]["tops_window_device_time"]
    assert a["evidence"]["miss_factor"] == 20.0
    last_w = _snap(2, {"q": {
        "2": _rec(6, 1200, 900.0, est=10),
        "3": _rec(6, 60, 99000.0, est=10, kind="Scan"),
    }})
    alerts = [a for a in sen.evaluate_window(first, last_w)
              if a["rule"] == "cardinality_misestimate"]
    assert [a["severity"] for a in alerts] == ["warn"]


@pytest.mark.parametrize("sen", (JSEN, TSEN), ids=("jax", "torch"))
def test_misestimate_rule_thresholds_and_edge_trigger(sen):
    def fires(first, last):
        return [a for a in sen.evaluate_window(first, last)
                if a["rule"] == "cardinality_misestimate"]

    few = _snap(2, {"q": {"2": _rec(4, 800, 100.0, est=10)}})
    assert not fires(_snap(1, {}), few)
    ok = _snap(2, {"q": {"2": _rec(6, 420, 100.0, est=10)}})
    assert not fires(_snap(1, {}), ok)
    bad0 = _snap(1, {"q": {"2": _rec(6, 1200, 100.0, est=10)}})
    bad1 = _snap(2, {"q": {"2": _rec(12, 2400, 200.0, est=10)}})
    assert not fires(bad0, bad1)
    clean0 = _snap(1, {"q": {"2": _rec(2, 20, 10.0, est=10)}})
    assert fires(clean0, bad1)


@pytest.mark.parametrize("sen", (JSEN, TSEN), ids=("jax", "torch"))
def test_misestimate_alert_dedup_in_sentinel_ring(sen):
    first = _snap(1, {})
    last = _snap(2, {"q": {"2": _rec(6, 1200, 9000.0, est=10)}})
    hs = sen.HealthSentinel()
    fresh = hs.observe(first, last)
    assert [a.rule for a in fresh] == ["cardinality_misestimate"]
    assert hs.observe(first, last) == []
    last2 = _snap(3, {"q": {"2": _rec(12, 2400, 18000.0, est=10)}})
    last2["plan_profile"]["digests"]["q"]["2"]["avg_rows"] = 200.0
    assert hs.observe(last, last2) == []


# ---- slow-query watermark arms the profiler ---------------------------------


def test_slow_statement_forces_next_profile(db, fused):
    q = MIX["q1"]
    digest = P.digest_text(q)
    for x in (db.j, db.t):
        s = x.session()
        try:
            x.config.set("trace_log_slow_query_watermark", "0")
            marks0 = x.plan_profiler.slow_marks
            s.sql(q).rows()
            assert x.plan_profiler.slow_marks > marks0
        finally:
            x.config.set("trace_log_slow_query_watermark", "3600")
        execs0 = {r["node_id"]: r["executions"]
                  for r in x.plan_profiler.store.digest_profile(digest)}
        s.sql(q).rows()
        opp = x.engine.last_op_profile
        assert opp is not None and opp["reason"] == "forced"
        execs1 = {r["node_id"]: r["executions"]
                  for r in x.plan_profiler.store.digest_profile(digest)}
        assert all(execs1[n] == execs0.get(n, 0) + 1 for n in execs1)
        recs = [b for b in x.flight.records() if b.get("digest") == digest]
        assert recs and "op_profile" in recs[-1]


def test_profiled_slow_run_does_not_rearm(db, fused):
    q = MIX["q6"]
    digest = P.digest_text(q)
    for x in (db.j, db.t):
        s = x.session()
        try:
            x.config.set("trace_log_slow_query_watermark", "0")
            x.plan_profiler.force_next(digest)
            marks0 = x.plan_profiler.slow_marks
            s.sql(q).rows()
            assert x.engine.last_op_profile is not None
            assert x.plan_profiler.slow_marks == marks0
            s.sql(q).rows()
            opp = x.engine.last_op_profile
            assert opp is None or opp["reason"] != "forced"
        finally:
            x.config.set("trace_log_slow_query_watermark", "3600")
