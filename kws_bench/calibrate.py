"""Readings that the limits of a cell's compared numbers are set from
(not run by the benchmark's runs).

    python -m kws_bench.calibrate --workload <cell> --seeds 12 \\
        [--control 3] [--faults 3] [--fault NAME ...] [--first-seed N]

For each seed the program's numbers against the reference, as a run
compares them (without the window); then, on ``--control`` seeds, the
precision control's (the reference in a lower precision in the
program's place) and, on ``--faults`` seeds, each planted fault's (the
driver's ``FAULTS``, or those named by ``--fault``). One
JSON line per reading, then a summary: the largest reading of the
program's sound runs (the lower reading) and the smallest of the
control's and of each fault's (the upper ones).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import torch

from kws_bench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--fault", action="append")
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    harness.use_checkout_caches()
    spec = harness.load_spec()
    cell = harness.find_cell(spec, args.workload)
    mix = harness.load_traffic(cell["traffic"])
    drv = harness.driver(mix["kind"])
    rows = []
    with tempfile.TemporaryDirectory(prefix="kws_calibrate_") as wd:
        roles = [("program", args.seeds), ("control", args.control)] + [
            (f, args.faults) for f in args.fault or drv.FAULTS]
        for r, (role, n) in enumerate(roles):
            for i in range(n):
                seed = args.first_seed + 7919 * i + r
                run_dir = os.path.join(wd, f"{role}{i}")
                os.makedirs(run_dir)
                ctx = harness.Context(
                    cell=cell, config=harness.load_config(cell["config"]),
                    mix=mix, limits={}, seed=seed, seconds=0.0, trace=False,
                    device=torch.device("cuda", 0), workdir=run_dir)
                for name, numbers in drv.readings(ctx, role).items():
                    row = {"role": role, "reading": name, "seed": seed,
                           **numbers}
                    rows.append(row)
                    print(json.dumps(row), flush=True)
                shutil.rmtree(run_dir)
    summary = {}
    for row in rows:
        for k, v in row.items():
            if k in ("role", "reading", "seed") or not isinstance(
                    v, (int, float)):
                continue
            key = f"{row['reading']}.{k}"
            agg = max if row["role"] == "program" else min
            summary[key] = v if key not in summary else agg(summary[key], v)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
