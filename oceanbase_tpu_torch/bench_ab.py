"""The shared part of the kernel A/B harnesses (`bench_k2.py`,
`bench_k3.py`, `bench_k4.py`, `bench_k7.py`, `bench_k8.py`,
`bench_k10.py`, `bench_k13.py`, `bench_k15.py`, `bench_k17.py`,
`bench_k24.py`, `bench_k26.py`): each times one kernel at
the shapes chip_smoke times it at, so two versions of the kernel can be
compared on one card in one call.

Every harness takes `--root DIR` and `--reps N`. `--root` imports
`oceanbase_tpu_torch` from another checkout (its kernels built there), so
parent and change are timed alike; run them as parent, change, change,
parent:

    for r in parent . . parent; do
      python3 oceanbase_tpu_torch/bench_k8.py --root $r; done

The harnesses are run by path, so this module is imported as a sibling of
the script, never from the checkout under test.
"""

import argparse
import json
import os
import sys


def start(name: str, reps: int):
    """Parse `--root` and `--reps`, import torch and the kernels of the
    checkout at `--root`: (root, reps, torch, kernels, the card), or None
    (after a line on stderr) when there is no CUDA card."""
    ap = argparse.ArgumentParser(prog=name)
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=reps)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from oceanbase_tpu_torch import kernels

    if not torch.cuda.is_available():
        print(f"{name} needs a CUDA card", file=sys.stderr)
        return None
    return root, args.reps, torch, kernels, torch.device("cuda", 0)


def same(torch, got, want) -> bool:
    """Every tensor of `got` equals its twin in `want`, type and bits."""
    return len(got) == len(want) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))


def timed(torch, fn, reps: int) -> float:
    """Mean milliseconds of `reps` back-to-back calls of `fn` after one
    warm-up, between two CUDA events (the wrapper's host work included, as
    chip_smoke times kernels)."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def interleaved(torch, fns, rounds: int) -> list:
    """The median milliseconds of each of fns, timed in turns over the
    same rounds (CUDA events around one call each, after one warm-up call:
    a single call's host work before its launch is in its interval), as
    chip_smoke.py's interleaved_ms."""
    import statistics

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(rounds):
        for fn, t in zip(fns, times):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            t.append(s.elapsed_time(e))
    return [statistics.median(t) for t in times]


def device_kernels(torch, fn, calls: int = 5) -> dict:
    """{kernel: device ms a call} over `calls` calls of fn (memsets and
    copies included), from torch.profiler, or {} when it saw no device
    event."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or 0
        if us and e.device_type.name == "CUDA":
            out[e.key.split("(")[0]] = us / calls / 1e3
    return out


def report(torch, root: str, **fields) -> None:
    """One JSON line: the root, the card's name, then `fields`."""
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0),
                      **fields}), flush=True)


def chained_sort(torch, keys, desc, live):
    """K3's yardstick (bench_k3.py and chip_smoke's K3 record): one stable
    torch.sort a key, least significant first, the dead flag last (most
    significant)."""
    perm = torch.arange(live.shape[0], device=live.device)
    for k, d in reversed([(~live, False), *zip(keys, desc)]):
        kk = (-k if d else k)[perm]
        perm = perm[torch.sort(kk, stable=True).indices]
    return perm
