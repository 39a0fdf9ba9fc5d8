#!/usr/bin/env python3
"""Which guard keeps the profiler's kernel records of a timed call whole.

    python3 tools/perf/profile_records_probe.py GUARD [--out FILE]

Runs chip_smoke.py's whole path on one card with its
``kernel_device_ms`` replaced by one of four guards, each a profile of
20 calls after a warm-up call, tried up to 3 times:

  cuda            CUDA activity only, the calls alone
  cpu+cuda        CPU and CUDA activities, the calls alone
  cuda+marks      CUDA only, 64 ``torch.cuda._sleep`` marker kernels on
                  the same stream before the calls and 64 after
  cpu+cuda+marks  both activities and the markers

A profile is short when it holds no kernel record of the calls, a number
of some kernel's records that is not a whole multiple of the calls, or
(with markers) no marker record on one side of the calls' records.  Each
call's record counts go to ``--out`` (JSON lines; by default
runs/profile_records/GUARD.jsonl); the last line prints
the calls, the profiles short at the first try, and the calls left not
measured after the third, beside the card's name and power limit.  Run
each guard in a process of its own: a profiler session can change what
later ones in the same process record.
"""
import argparse
import collections
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

PAD, MARK = 64, "spin_kernel"
GUARDS = {"cuda": (False, False), "cpu+cuda": (True, False),
          "cuda+marks": (False, True), "cpu+cuda+marks": (True, True)}


def guarded(cpu, marks, log):
    """A ``kernel_device_ms`` under one guard, writing each call's record
    counts to ``log``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])

    def measure(fn, iters=20, tries=3):
        fn()
        torch.cuda.synchronize()
        row = {"records": []}
        for _ in range(tries):
            with profile(activities=acts) as prof:
                for _ in range(PAD if marks else 0):
                    torch.cuda._sleep(1)
                for _ in range(iters):
                    fn()
                for _ in range(PAD if marks else 0):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
            spans = sorted(
                (e.time_range.start, e.time_range.end, e.name)
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
            own = [i for i, sp in enumerate(spans) if MARK not in sp[2]]
            count = collections.Counter(spans[i][2] for i in own)
            row["records"].append(len(own))
            whole = own and all(c % iters == 0 for c in count.values()) and (
                not marks or (own[0] > 0 and own[-1] < len(spans) - 1))
            if whole:
                log.write(json.dumps(row) + "\n")
                by_name = collections.Counter()
                for i in own:
                    start, end, name = spans[i]
                    by_name[name] += (end - start) / 1e3 / iters
                return sum(by_name.values()), dict(by_name), ""
        row["missed"] = True
        log.write(json.dumps(row) + "\n")
        return None, {}, f"records {row['records']}"

    return measure


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("guard", choices=list(GUARDS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = args.out or os.path.join(ROOT, "runs", "profile_records",
                                   f"{args.guard}.jsonl")
    os.makedirs(os.path.dirname(out), exist_ok=True)

    import chip_smoke

    t0 = time.perf_counter()
    with open(out, "w") as log:
        chip_smoke.kernel_device_ms = guarded(*GUARDS[args.guard], log)
        try:
            chip_smoke.main()
        finally:
            log.flush()
            rows = [json.loads(r) for r in open(out)]
            first = sum(len(r["records"]) > 1 or "missed" in r for r in rows)
            missed = sum("missed" in r for r in rows)
            print(f"profile_records_probe: {args.guard}: {len(rows)} calls, "
                  f"{first} short at the first try, {missed} not measured "
                  f"after the third, {time.perf_counter() - t0:.1f} s "
                  f"[{chip_smoke.power_line()}]")


if __name__ == "__main__":
    main()
