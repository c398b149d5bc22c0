"""PX over a mesh that spans processes: the port's twin of
tests/test_px_multiproc.py.

Two spawned processes join one gloo process group; each holds 4 `cpu`
shards of one 8-shard mesh (`parallel.mesh.process_mesh`), runs them in
threads of its own, and the collectives cross between the processes
through torch.distributed (parallel/group.py). Both processes must return
the same rows, equal to the port's single-process 8-shard PxExecutor and
to the JAX package's single-process Executor; the sharded kNN over a
2-process mesh must equal the single-process one; a shard that raises in
one process must end the run in both, with its error, inside the test's
own time limit.

The children import the port and never JAX (this module imports JAX only
inside the tests, in the parent). Every wait is bounded: the process
group's timeout, `q.get(timeout=...)`, then `terminate`.
"""

import multiprocessing as mp
import queue
import socket
import time

import numpy as np

QIDS = (1, 3, 6)
SF = 0.01
SEED = 19920101
NPROCS = 2
PER = 4
PG_TIMEOUT_S = 60
WAIT_S = 150


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _join(rank: int, port: int):
    from datetime import timedelta

    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=NPROCS,
        rank=rank, timeout=timedelta(seconds=PG_TIMEOUT_S))


def _no_jax() -> None:
    import sys

    assert "jax" not in sys.modules, "a child process imported JAX"


def _px_worker(rank: int, port: int, q):
    import torch
    import torch.distributed as dist

    try:
        _join(rank, port)
        from oceanbase_tpu_torch.core.column import batch_to_host
        from oceanbase_tpu_torch.models.tpch import datagen
        from oceanbase_tpu_torch.models.tpch.sql_suite import (
            QUERIES,
            UNIQUE_KEYS,
        )
        from oceanbase_tpu_torch.parallel.group import WIRE_BYTES
        from oceanbase_tpu_torch.parallel.mesh import process_mesh
        from oceanbase_tpu_torch.parallel.px import PxExecutor
        from oceanbase_tpu_torch.sql.parser import parse
        from oceanbase_tpu_torch.sql.planner import Planner

        mesh = process_mesh([torch.device("cpu")] * PER, "gloo")
        assert mesh.size == NPROCS * PER
        assert mesh.local_shards() == tuple(range(rank * PER,
                                                  (rank + 1) * PER))
        # every process generates (and passes) the whole tables
        tables = datagen.generate(sf=SF, seed=SEED)
        planner = Planner(tables)
        px = PxExecutor(tables, mesh, unique_keys=UNIQUE_KEYS)
        out = {}
        for qid in QIDS:
            planned = planner.plan(parse(QUERIES[qid]))
            # PxExecutor.execute is prepare + run; the prepared plan
            # keeps the MeshPlan
            prepared = px.prepare(planned.plan)
            b = prepared.run()
            out[qid] = (list(planned.output_names), batch_to_host(b),
                        prepared.mesh_plan.cross_process_bytes)
        _no_jax()
        q.put(("ok", rank, out, WIRE_BYTES["sent"]))
    except BaseException as e:  # noqa: BLE001 - surfaced by the parent
        import traceback

        q.put(("err", rank, f"{e!r}\n{traceback.format_exc()}", 0))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _knn_worker(rank: int, port: int, q, x, arrays, queries):
    import torch
    import torch.distributed as dist

    try:
        _join(rank, port)
        from oceanbase_tpu_torch.parallel.ann import shard_ivf
        from oceanbase_tpu_torch.parallel.mesh import process_mesh
        from oceanbase_tpu_torch.storage.vector_index import ivf_from_arrays

        mesh = process_mesh([torch.device("cpu")] * 2, "gloo")
        siv = shard_ivf(mesh, x, ivf_from_arrays(*arrays))
        assert siv.xs[rank * 2] is not None
        assert siv.xs[(1 - rank) * 2] is None  # another process's block
        res = [siv.search(qv, k=10, nprobe=4) for qv in queries]
        _no_jax()
        q.put(("ok", rank, (res, siv.mesh_plan.ops_by_collective()), 0))
    except BaseException as e:  # noqa: BLE001
        import traceback

        q.put(("err", rank, f"{e!r}\n{traceback.format_exc()}", 0))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _fail_worker(rank: int, port: int, q):
    import torch
    import torch.distributed as dist

    try:
        _join(rank, port)
        from oceanbase_tpu_torch.parallel.group import current, run_spmd
        from oceanbase_tpu_torch.parallel.mesh import process_mesh

        mesh = process_mesh([torch.device("cpu")] * PER, "gloo")
        seen = []

        def before(i):
            # shard 5 (process 1) raises before the first collective
            if i == 5:
                raise ValueError("shard five fails before the gather")
            current().gather(torch.tensor([i]))
            return i

        def after(i):
            # shard 2 (process 0) raises after the last collective
            vals = current().gather(torch.tensor([i]))
            if i == 2:
                raise KeyError("shard two fails after the gather")
            return int(sum(int(v) for v in vals))

        for fn in (before, after):
            t0 = time.perf_counter()
            try:
                run_spmd(mesh, fn)
                seen.append(("returned", None, 0.0))
            except BaseException as e:  # noqa: BLE001
                seen.append((type(e).__name__, str(e),
                             time.perf_counter() - t0))

        def clean(i):
            return int(sum(int(v) for v in current().gather(
                torch.tensor([i]))))

        # the group is still in step: a clean run afterwards
        total = run_spmd(mesh, clean)
        seen.append(("clean", [t for t in total if t is not None], 0.0))
        _no_jax()
        q.put(("ok", rank, seen, 0))
    except BaseException as e:  # noqa: BLE001
        import traceback

        q.put(("err", rank, f"{e!r}\n{traceback.format_exc()}", 0))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn(target, *args) -> dict:
    """Run target(rank, port, q, *args) in NPROCS spawned processes; the
    results by rank. Every wait is bounded and no process outlives it."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, port, q, *args),
                         daemon=True) for r in range(NPROCS)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + WAIT_S
    try:
        while len(results) < NPROCS:
            assert time.monotonic() < deadline, \
                f"no result from every process in {WAIT_S} s"
            try:
                kind, rank, payload, wire = q.get(timeout=5)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                assert not dead, f"a process died without a result: {dead}"
                continue
            assert kind == "ok", f"process {rank} failed:\n{payload}"
            results[rank] = (payload, wire)
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        alive = [p.pid for p in procs if p.is_alive()]
        assert not alive, f"processes left alive: {alive}"
    return results


def test_px_two_process_global_mesh():
    """Q1, Q3, Q6 over 2 processes x 4 shards: both processes equal, equal
    to the port's single-process 8-shard mesh and to the JAX Executor."""
    from torch_twins import host_rows_sorted, px_rows, rows_equal

    from oceanbase_tpu.engine.executor import Executor as JExecutor
    from oceanbase_tpu.models.tpch import datagen as JD
    from oceanbase_tpu.sql.parser import parse as jparse
    from oceanbase_tpu.sql.planner import Planner as JPlanner
    from oceanbase_tpu_torch.models.tpch import datagen as TD
    from oceanbase_tpu_torch.models.tpch.sql_suite import QUERIES, UNIQUE_KEYS
    from oceanbase_tpu_torch.parallel.mesh import make_mesh
    from oceanbase_tpu_torch.parallel.px import PxExecutor
    from oceanbase_tpu_torch.sql.parser import parse
    from oceanbase_tpu_torch.sql.planner import Planner

    results = _spawn(_px_worker)
    rows = {r: {qid: host_rows_sorted(host, names)
                for qid, (names, host, _x) in out.items()}
            for r, (out, _w) in results.items()}
    # both processes ran one SPMD program: identical rows
    assert rows[0] == rows[1]
    # rows crossed between the processes, and the MeshPlan says so
    assert all(w > 0 for _o, w in results.values())
    assert results[0][0][3][2] > 0

    tt = TD.generate(sf=SF, seed=SEED)
    planner = Planner(tt)
    single = PxExecutor(tt, make_mesh(devices=["cpu"] * NPROCS * PER),
                        unique_keys=UNIQUE_KEYS)
    jt = JD.generate(sf=SF, seed=SEED)
    jplanner = JPlanner(jt)
    jex = JExecutor(jt, unique_keys=UNIQUE_KEYS)
    for qid in QIDS:
        tp = planner.plan(parse(QUERIES[qid]))
        names = list(tp.output_names)
        srows = px_rows(single.execute(tp.plan), names)
        assert rows[0][qid] == srows, f"q{qid}: 2 processes vs one"
        jp = jplanner.plan(jparse(QUERIES[qid]))
        rows_equal(px_rows(jex.execute(jp.plan), names), rows[0][qid],
                   f"q{qid}: 2 processes vs the JAX Executor")
        assert len(srows) > 0


def test_sharded_knn_over_two_processes():
    """parallel/ann.py over a 4-shard mesh of 2 processes returns exactly
    the single-process 4-shard search."""
    import torch

    from oceanbase_tpu_torch.parallel.ann import shard_ivf
    from oceanbase_tpu_torch.parallel.mesh import make_mesh
    from oceanbase_tpu_torch.storage.vector_index import build_ivf

    rng = np.random.default_rng(23)
    x = rng.normal(size=(4000, 16)).astype(np.float32)
    idx = build_ivf(x, lists=32, device="cpu")
    arrays = (idx.centroids, idx.perm, idx.offsets, idx.lengths)
    queries = [rng.normal(size=16).astype(np.float32) for _ in range(5)]
    results = _spawn(_knn_worker, x, arrays, queries)
    single = shard_ivf(make_mesh(devices=[torch.device("cpu")] * 4), x, idx)
    want = [single.search(qv, k=10, nprobe=4) for qv in queries]
    for r in range(NPROCS):
        got, colls = results[r][0]
        assert colls.get("all_gather", 0) >= 1
        for (gi, gd), (wi, wd) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gd, wd)


def test_failing_shard_ends_the_run_in_every_process():
    """A shard that raises in one process ends the run in both, with its
    error, before and after the last collective; no process blocks in a
    collective, and the group stays usable."""
    results = _spawn(_fail_worker)
    for rank in range(NPROCS):
        seen = results[rank][0]
        before, after, clean = seen
        assert before[0] == ("ValueError" if rank == 1
                             else "RemoteShardError"), before
        assert "shard five fails before the gather" in before[1]
        assert after[0] == ("KeyError" if rank == 0
                            else "RemoteShardError"), after
        assert "shard two fails after the gather" in after[1]
        assert before[2] < PG_TIMEOUT_S and after[2] < PG_TIMEOUT_S
        assert clean[0] == "clean"
        assert clean[1] == [sum(range(NPROCS * PER))] * PER
