"""The port's memory governor against the JAX package's: the ledger,
reservation and staged-lease cases of tests/test_memory_governor.py that
need no server. Every case runs on both governors and must see the same
grants, clamps, rejects and balances. The port's auto budget is the
synthetic one on the CPU; the executor's default budget there is the
library default, so CPU statements route as the JAX Executor does.
"""

import random
import threading

import pytest

from oceanbase_tpu.engine import memory_governor as JG
from oceanbase_tpu_torch.engine import chunked as TCH
from oceanbase_tpu_torch.engine import memory_governor as TG
from oceanbase_tpu_torch.engine.executor import Executor

GOVS = [JG, TG]
IDS = ["jax", "torch"]


@pytest.fixture(params=GOVS, ids=IDS)
def G(request):
    return request.param


def test_grant_charges_and_release_refunds(G):
    gov = G.MemoryGovernor(budget=1 << 20)
    r = gov.reserve("sys", 1000, timeout_s=0.1)
    assert r is not None and r.nbytes == 1000
    assert gov.reserved == 1000 and gov.grants == 1
    r.release()
    r.release()  # idempotent: a double release must not go negative
    assert gov.reserved == 0 and gov.ledger_balanced()


def test_zero_byte_reservation_is_free(G):
    gov = G.MemoryGovernor(budget=1 << 20)
    with gov.reserve("sys", 0) as r:
        assert isinstance(r, G.Reservation) and r.nbytes == 0
        assert gov.reserved == 0
    assert gov.ledger_balanced()


def test_oversized_request_clamped_runs_strictly_alone(G):
    gov = G.MemoryGovernor(budget=10_000)
    big = gov.reserve("sys", 1 << 30, timeout_s=0.1)
    assert big is not None and big.nbytes == gov.effective_budget()
    assert gov.reserve("sys", 1, timeout_s=0.05) is None  # pool is full
    assert gov.rejects == 1
    big.release()
    assert gov.ledger_balanced()


def test_note_oom_shrinks_multiplicatively_with_floor(G):
    gov = G.MemoryGovernor(budget=1000)
    for _ in range(20):
        gov.note_oom()
    assert gov.effective_budget() == 250  # OOM_SHRINK_FLOOR
    assert gov.oom_notes == 20
    gov.reset_shrink()
    assert gov.effective_budget() == 1000


def test_waiter_clamps_against_the_shrunk_pool(G):
    gov = G.MemoryGovernor(budget=1000)
    hold = gov.reserve("sys", 1000, timeout_s=0.1)
    got = []

    def waiter():
        got.append(gov.reserve("sys", 900, timeout_s=5.0))

    th = threading.Thread(target=waiter)
    th.start()
    gov.note_oom()  # effective budget now 750 < the waiter's 900
    hold.release()
    th.join(timeout=10)
    assert got and got[0] is not None
    assert got[0].nbytes == 750
    got[0].release()
    assert gov.ledger_balanced()


def test_queue_depth_backpressure_rejects_without_waiting(G):
    gov = G.MemoryGovernor(budget=1000, max_queue=1)
    hold = gov.reserve("sys", 1000, timeout_s=0.1)
    stop = threading.Event()

    def parked():
        r = gov.reserve("sys", 500, timeout_s=30.0)
        stop.wait()
        if r is not None:
            r.release()

    th = threading.Thread(target=parked, daemon=True)
    th.start()
    for _ in range(100):
        with gov._cond:
            if gov._waiters >= 1:
                break
        threading.Event().wait(0.01)
    assert gov.reserve("sys", 1, timeout_s=30.0) is None
    assert gov.rejects == 1
    hold.release()
    stop.set()
    th.join(timeout=10)
    assert gov.ledger_balanced()


def test_tenant_lone_statement_always_admissible(G):
    gov = G.MemoryGovernor(budget=1 << 20)
    gov.register_tenant("tiny", 30 * 1024, resident_fn=lambda: 48 * 1024)
    r = gov.reserve("tiny", 16 << 20, timeout_s=0.1)
    assert r is not None and r.nbytes == 30 * 1024
    assert gov.reserve("tiny", 1024, timeout_s=0.05) is None
    r.release()
    assert gov.ledger_balanced()


def test_derive_chunk_rows_bounds(G):
    assert G.derive_chunk_rows(0, 1 << 20) == 4096
    assert G.derive_chunk_rows(1 << 40, 65536) == 65536
    assert G.derive_chunk_rows(128 * 10_000, 1 << 20) == 10_000


def test_staged_leases_balance_and_track_the_peak(G):
    gov = G.MemoryGovernor(budget=1 << 20)
    a = gov.stage("sys", 300)
    with gov.stage("sys", 500) as b:
        assert gov.staged == 800 and b.nbytes == 500
        assert not gov.ledger_balanced()
    a.release()
    a.release()
    assert gov.staged == 0 and gov.peak_staged == 800
    assert gov.ledger_balanced()
    st = gov.stats()
    assert (st["staged"], st["peak_staged"]) == (0, 800)


def test_reservation_hammer_8_threads_exact_balance(G):
    gov = G.MemoryGovernor(budget=1 << 20, max_queue=64)
    gov.register_tenant("even", None)
    gov.register_tenant("odd", 600_000)
    iters, nthreads = 100, 8
    granted = [0] * nthreads
    failed: list[Exception] = []

    def worker(tid: int):
        rng = random.Random(0xA11CE + tid)
        tenant = "even" if tid % 2 == 0 else "odd"
        for _ in range(iters):
            r = gov.reserve(tenant, rng.randrange(1, 300_000),
                            timeout_s=30.0)
            if r is None:
                failed.append(TimeoutError(f"t{tid} starved"))
                return
            granted[tid] += 1
            try:
                with r:
                    if rng.random() < 0.3:
                        raise KeyError("error path: __exit__ must refund")
            except KeyError:
                pass

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not failed
    assert sum(granted) == iters * nthreads == gov.grants
    assert gov.rejects == 0
    assert gov.reserved == 0 and gov.ledger_balanced()
    assert gov.peak_reserved <= gov.budget
    assert all(t["reserved"] == 0 for t in gov.stats()["tenants"].values())


def test_detect_device_budget_is_synthetic_on_cpu(monkeypatch):
    monkeypatch.delenv("OB_TPU_SYNTHETIC_HBM", raising=False)
    assert TG.detect_device_budget("cpu") == TG.SYNTHETIC_CPU_BUDGET
    monkeypatch.setenv("OB_TPU_SYNTHETIC_HBM", str(3 << 20))
    assert TG.detect_device_budget("cpu") == 3 << 20
    assert TG.AUTO_HBM_FRACTION == JG.AUTO_HBM_FRACTION


def test_executor_default_budget_on_cpu_is_the_library_default():
    ex = Executor({}, device="cpu")
    assert ex.device_budget == TCH.DEFAULT_DEVICE_BUDGET
    assert ex.chunk_rows == TCH.DEFAULT_CHUNK_ROWS
    assert Executor({}, device="cpu", device_budget=1 << 20,
                    chunk_rows=4096).device_budget == 1 << 20
