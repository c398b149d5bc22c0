"""Time K24 (the fused expression kernel) at the shape of TPC-H Q6's
predicate, at Q19's predicate (whose largest chunk is its 71-instruction
one), and over every program of Q1, Q6, Q7, Q14 and Q19, so two versions
of the kernel can be compared on one card in one call.

    python3 oceanbase_tpu_torch/bench_k24.py [--root DIR] [--reps N]

The programs: the statements run twice through the checkout's own Session
on the card at SF 0.01 (TPC-H's generator, seed SEED), every tree, batch
and parameter frame of the second (warm) run, which binds the packed
parameter row, captured at `expr.compile._fused`. Each batch is then tiled on the card to ROWS
rows (lineitem's capacity at SF 10), the trees run once more through
`_fused` over it, and the programs K24 ran with (lowered by the
checkout's own `expr/program.py`) are captured with their parameter rows.
K24's results are held to its plain version bit for bit first. `--root`
and the parent / change order are as `bench_ab.py` says. Prints one JSON
line: the root, the card, for Q6's and Q19's predicates the mean
milliseconds of `reps` calls (`bench_ab.timed`), the rows, the chunks,
the instructions, each chunk's rows a thread, the bytes K24 must move (each input read once, each output written once) and
the bound at 3.35 TB/s; and per statement the mean milliseconds of one
run of all its programs, each at ROWS rows.
"""

import dataclasses
import sys

try:
    from . import bench_ab
except ImportError:
    import bench_ab

ROWS = 59_998_208
SEED = 19920101
STATEMENTS = (1, 6, 7, 14, 19)
HBM_BYTES_PER_S = 3.35e12


def _bytes(prog, batch, ext) -> int:
    """Inputs read once (temporaries not counted), outputs written once."""
    seen, total = set(), 0
    luts = prog.luts_on(batch.sel.device)
    for ch in prog.chunks:
        for d in ch.inputs:
            if d in seen or d[0] == "tmp":
                continue
            seen.add(d)
            t = (batch.cols[d[1]] if d[0] == "col" else
                 batch.valid[d[1]] if d[0] == "valid" else
                 batch.sel if d[0] == "sel" else
                 luts[d[1]] if d[0] == "lut" else
                 ext[d[1]][0 if d[0] == "ext" else 1])
            total += t.numel() * t.element_size()
    return total + sum(batch.capacity * dt.itemsize for dt in prog.out_dtypes)


def main() -> int:
    got = bench_ab.start("bench_k24", reps=50)
    if got is None:
        return 1
    root, reps, torch, kernels, dev = got
    from oceanbase_tpu_torch.engine.session import Session
    from oceanbase_tpu_torch.expr import compile as xc
    from oceanbase_tpu_torch.models.tpch import datagen, sql_suite

    sess = Session(datagen.generate(sf=0.01, seed=SEED),
                   unique_keys=sql_suite.UNIQUE_KEYS, device=dev.type)
    calls = {}
    orig = xc._fused

    def capture(exprs, batch, predicate):
        calls.setdefault(q, []).append(
            (exprs, batch, predicate, xc._active_params()))
        return orig(exprs, batch, predicate)

    for q in STATEMENTS:
        sess.sql(sql_suite.QUERIES[q]).rows()
        xc._fused = capture  # the warm run, which binds the packed row
        try:
            sess.sql(sql_suite.QUERIES[q]).rows()
        finally:
            xc._fused = orig

    def tiled(small):
        reps_n = -(-ROWS // small.capacity)

        def tile(t):
            return t.repeat(reps_n)[:ROWS].contiguous()

        big = dataclasses.replace(
            small, cols={k: tile(v) for k, v in small.cols.items()},
            valid={k: tile(v) for k, v in small.valid.items()},
            sel=tile(small.sel))
        return dataclasses.replace(big, nrows=big.sel.sum())

    def programs(exprs, big, predicate, frame):
        """The K24 runs (program, batch, qrow, ext) of the trees over big."""
        ran = []
        fx = kernels.fused_expr

        def record(program, batch, qrow=None, ext=()):
            ran.append((program, batch, qrow, list(ext)))
            return fx(program, batch, qrow, ext)

        kernels.fused_expr = record
        prev = xc.set_params(frame)
        try:
            xc._fused(exprs, big, predicate)
        finally:
            xc.set_params(prev)
            kernels.fused_expr = fx
        return ran

    def bits(ts):
        # floats as their bit patterns: a NaN equals a NaN of the same bits
        return [t.view({torch.float64: torch.int64,
                        torch.float32: torch.int32}.get(t.dtype, t.dtype))
                for t in ts]

    def held(runs, what):
        for prog, big, qrow, ext in runs:
            res = kernels.fused_expr(prog, big, qrow, ext)
            want = kernels.fused_expr_plain(prog, big, qrow, ext)
            if not bench_ab.same(torch, bits(res), bits(want)):
                print(f"K24 {what} differs from its plain version",
                      file=sys.stderr)
                return False
        return True

    out, per = {}, {}
    for q in STATEMENTS:
        runs = []
        for exprs, small, predicate, frame in calls[q]:
            runs += programs(exprs, tiled(small), predicate, frame)
        if not held(runs, f"Q{q}"):
            return 1

        def all_runs(runs=runs):
            for prog, big, qrow, ext in runs:
                kernels.fused_expr(prog, big, qrow, ext)

        per[f"Q{q}"] = {"ms": bench_ab.timed(torch, all_runs, reps),
                        "programs": len(runs)}
        if q in (6, 19):
            # the statement's predicate with the most instructions
            preds = [r for r in runs if r[0].out_dtypes == [torch.bool]]
            prog, big, qrow, ext = max(
                preds, key=lambda r: sum(len(c.code) for c in r[0].chunks))
            ms = bench_ab.timed(torch, lambda: kernels.fused_expr(
                prog, big, qrow, ext), reps)
            nbytes = _bytes(prog, big, ext)
            out[f"Q{q}"] = {
                "ms": ms, "rows": ROWS, "chunks": len(prog.chunks),
                "instructions": [len(ch.code) + len(getattr(ch, "ucode", ()))
                                 for ch in prog.chunks],
                # rows a thread (None where the chunk has no such field)
                "rows_per_thread": [getattr(ch, "rows", None)
                                    for ch in prog.chunks],
                "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        del runs
    out["statements"] = per
    bench_ab.report(torch, root, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
