#!/usr/bin/env python3
"""Where `chip_smoke.py`'s own time goes: run its main() with every
function of the module under a wall timer and write, per function, the
inclusive and exclusive seconds and the calls, most exclusive first.

Run from the repository root on the card machine:

    python3 tools/chip_smoke_times.py [--no-ab] [--check-events N]
        [--out chip_smoke_times.json]

``--no-ab`` leaves out phase 8's forgetting A/B (its children are not
started). ``--check-events N`` holds ``chip_smoke.device_events`` against
the profiler's own ``key_averages()`` in the first N profiles (kernels,
launches and device us) and prints what ``key_averages()`` took. The
process's and its children's CPU seconds are printed at the end.
"""
from __future__ import annotations

import argparse
import collections
import functools
import inspect
import json
import os
import resource
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# functions left unwrapped: the entry point, and context managers and
# counters whose wrapping would only add noise
SKIP = {"main", "card_line", "reset_counts", "read_counts", "counters",
        "switched", "ghm_bins", "timed_jv", "card_alone", "cpu_worker",
        "cut_stacks", "summed_counts"}


def wrap_module():
    """Put every function of chip_smoke (FAMILIES' entries too) under a
    timer; returns {name: [inclusive s, exclusive s, calls]}."""
    times = collections.defaultdict(lambda: [0.0, 0.0, 0])
    inner_s = []

    def wrap(name, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            inner_s.append(0.0)
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                inner = inner_s.pop()
                entry = times[name]
                entry[0] += dt
                entry[1] += dt - inner
                entry[2] += 1
                if inner_s:
                    inner_s[-1] += dt
        return timed

    wrapped = {}
    for name, obj in list(vars(cs).items()):
        if inspect.isfunction(obj) and obj.__module__ == cs.__name__ \
                and name not in SKIP:
            wrapped[obj] = wrap(name, obj)
            setattr(cs, name, wrapped[obj])
    for fam in cs.FAMILIES.values():
        for key, value in list(fam.items()):
            if inspect.isfunction(value) and value in wrapped:
                fam[key] = wrapped[value]
    return times


def check_events(n):
    """Hold device_events against key_averages() in the first n profiles."""
    events = cs.device_events
    seen = [0]

    def checked(prof):
        got = events(prof)
        if seen[0] < n:
            seen[0] += 1
            t0 = time.perf_counter()
            ref = [e for e in prof.key_averages()
                   if e.device_type == cs.torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
            secs = time.perf_counter() - t0
            a = {e.key: (e.count, e.self_device_time_total) for e in got}
            b = {e.key: (e.count, e.self_device_time_total) for e in ref}
            both = set(a) & set(b)
            print(f"device_events against key_averages(): {len(a)} and "
                  f"{len(b)} kernels, {len(set(a) ^ set(b))} in one only, "
                  f"{sum(a[k][0] != b[k][0] for k in both)} launch counts "
                  f"differ, largest us difference "
                  f"{max([abs(a[k][1] - b[k][1]) for k in both] or [0]):.4f};"
                  f" key_averages() took {secs:.2f} s")
        return got

    cs.device_events = checked


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--no-ab", action="store_true")
    p.add_argument("--check-events", type=int, default=0, metavar="N")
    p.add_argument("--out", default="chip_smoke_times.json")
    args = p.parse_args(argv)
    times = wrap_module()
    if args.no_ab:
        cs.start_ab_seeds = lambda seeds=(): (time.perf_counter(), [])
        cs.check_forgetting_ab = lambda card, ab: print(
            "forgetting A/B left out")
    if args.check_events:
        check_events(args.check_events)
    t0 = time.perf_counter()
    try:
        rc = cs.main()
    finally:
        total = time.perf_counter() - t0
        own = resource.getrusage(resource.RUSAGE_SELF)
        kids = resource.getrusage(resource.RUSAGE_CHILDREN)
        print(f"cpu seconds: this process user {own.ru_utime:.1f} sys "
              f"{own.ru_stime:.1f}; its children user {kids.ru_utime:.1f} "
              f"sys {kids.ru_stime:.1f}")
        rows = sorted(times.items(), key=lambda kv: -kv[1][1])
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"total_s": total, "functions": {
                name: {"inclusive_s": round(v[0], 2),
                       "exclusive_s": round(v[1], 2), "calls": v[2]}
                for name, v in rows}}, f, indent=1)
        for name, (incl, excl, calls) in rows[:25]:
            print(f"{name:32s} exclusive {excl:8.1f} s  inclusive "
                  f"{incl:8.1f} s  calls {calls}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
