"""One run of one cell of the port's benchmark.

    python -m kws_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for. Set-up (making the data and weights from the seed, building
the kernels, the first steps that are checked, the warm-up) is timed
from the start of the process to the opening of the window, which lasts
``--seconds``. With ``--trace 1`` the window is timed as without, then
one ``torch.profiler`` capture of a short steady slice gives the
per-layer metrics. Then the program's outputs are compared with the
plain reference. The last line of stdout is the result as one JSON
object; the compared numbers and their limits are the last lines of
stderr and the result's last key. Without the card(s), or if a JAX
module was loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse     # noqa: E402
import json         # noqa: E402
import shutil       # noqa: E402
import sys          # noqa: E402
import tempfile     # noqa: E402

from kws_bench import harness   # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = harness.load_spec()
    cell = harness.find_cell(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"kws_bench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    harness.use_checkout_caches()
    device = torch.device("cuda", 0)
    workdir = tempfile.mkdtemp(prefix="kws_bench_")
    try:
        run = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                               bool(args.trace), device, workdir)
        loaded = harness.forbidden_loaded()
        if loaded:
            print(f"kws_bench: forbidden modules loaded: {loaded}",
                  file=sys.stderr)
            return 3
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": cell["chips"],
                "memory_peak_bytes": run.memory_peak_bytes}
        layers, breakdown = {}, None
        if args.trace:
            tr = run.layers["trace"]
            info["busy_s"] = tr["summary"]["busy_s"]
            info["window_s"] = tr["window_s"]
            layers = harness.read_layers(spec, args.workload, run.layers)
            from kws_bench.trace import breakdown as make_breakdown
            breakdown = make_breakdown(tr["summary"])
        line = harness.result_line(
            spec, args.workload, run, run.window_start - T_START,
            bool(args.trace), info, layers, breakdown)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if "host" in run.layers:
        print(f"host {json.dumps(run.layers['host'])}", file=sys.stderr)
    for c in run.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r})"
              f"{'' if c.ok else ' FAILED'}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
