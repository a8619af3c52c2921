"""Multi-seed sweep of the accuracy calibration (the port's counterpart
of scripts/seed_sweep.py).

    python -m speech_recognition_tpu_torch.tools.seed_sweep \\
        [--seeds 0,1,2,3,4] [--dtypes bfloat16,float32] [--epochs 30] \\
        [--model ...] [--int8_seeds 0,1,2] [--out FILE.jsonl] \\
        [--extra='--clips_per_word 60'] [--device cuda]

Runs ``python -m speech_recognition_tpu_torch.tools.calibrate_accuracy``
over a seeds x compute-dtypes grid, each run in a fresh interpreter,
appends one JSON record per run to a JSONL file (resumable: a run whose
record is there already is skipped), and prints a mean +/- sd aggregate
per dtype, the paired bf16-minus-f32 delta with its standard error, and
the int8 archives' accuracy delta. The JAX script's flags, keys and
aggregate, plus ``--device`` (passed through; default ``cuda``). The
default ``--out`` is ``docs/sweeps/torch_seed_sweep.jsonl`` in the
repository, beside the JAX records.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

REPO = pathlib.Path(__file__).resolve().parents[2]
CALIBRATE = "speech_recognition_tpu_torch.tools.calibrate_accuracy"


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Multi-seed accuracy sweep (PyTorch port)")
    p.add_argument("--seeds", default="0,1,2,3,4")
    p.add_argument("--dtypes", default="bfloat16,float32")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--model", default="conv_1d_time_sliced_with_attention")
    p.add_argument("--int8_seeds", default="0,1,2",
                   help="seeds (bf16 only) that also export float32 and "
                        "int8 archives and record the int8 delta")
    p.add_argument("--out", default=str(REPO / "docs" / "sweeps" /
                                        "torch_seed_sweep.jsonl"))
    p.add_argument("--timeout", type=int, default=1800)
    p.add_argument("--extra", nargs="*", default=[],
                   help="extra flags passed through to calibrate_accuracy; "
                        "argparse stops nargs='*' at the first '--'-"
                        "prefixed token, so pass ONE quoted string "
                        "(--extra='--clips_per_word 60'); items are split "
                        "on whitespace")
    p.add_argument("--device", default="cuda",
                   help="passed to calibrate_accuracy: 'cuda' (default) or "
                        "'cpu'")
    args = p.parse_args(argv)
    args.extra = [t for item in args.extra for t in item.split()]
    return args


def run_key(rec: Dict) -> Tuple:
    return (rec.get("model"), rec.get("compute_dtype"), rec.get("seed"),
            rec.get("epochs"), tuple(rec.get("extra", [])))


def load_existing(path: pathlib.Path) -> Dict[Tuple, Dict]:
    done = {}
    if path.exists():
        for line in path.read_text().splitlines():
            line = line.strip()
            if line:
                rec = json.loads(line)
                done[run_key(rec)] = rec
    return done


def mean_sd(xs: List[float]) -> Tuple[float, float]:
    n = len(xs)
    m = sum(xs) / n
    sd = math.sqrt(sum((x - m) ** 2 for x in xs) / (n - 1)) if n > 1 else 0.0
    return m, sd


def run_calibration(cmd: List[str], timeout: int
                    ) -> subprocess.CompletedProcess:
    """One calibration in a fresh interpreter, from the repository's
    root."""
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, cwd=str(REPO))


def last_record(stdout: str) -> Optional[Dict]:
    """The last JSON object line of a calibration's stdout."""
    for line in reversed(stdout.strip().splitlines()):
        if line.strip().startswith("{"):
            return json.loads(line)
    return None


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the missing runs and print the aggregate; returns it."""
    args = parse_args(argv)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",") if s != ""]
    dtypes = [d for d in args.dtypes.split(",") if d]
    int8_seeds = {int(s) for s in args.int8_seeds.split(",") if s != ""}
    done = load_existing(out)

    for dtype in dtypes:
        for seed in seeds:
            key = (args.model, dtype, seed, args.epochs, tuple(args.extra))
            if key in done:
                print(f"skip (cached): {dtype} seed {seed}", file=sys.stderr)
                continue
            cmd = [sys.executable, "-m", CALIBRATE,
                   "--model", args.model, "--epochs", str(args.epochs),
                   "--seed", str(seed), "--compute_dtype", dtype,
                   "--device", args.device, *args.extra]
            if dtype == "bfloat16" and seed in int8_seeds:
                cmd.append("--eval_int8")
            print(f"run: {dtype} seed {seed}", file=sys.stderr)
            proc = run_calibration(cmd, args.timeout)
            rec = last_record(proc.stdout)
            if proc.returncode != 0 or rec is None:
                print(proc.stderr[-2000:], file=sys.stderr)
                raise SystemExit(f"{dtype} seed {seed} failed "
                                 f"(rc={proc.returncode})")
            rec["seed"] = seed
            rec["extra"] = args.extra
            with out.open("a") as f:
                f.write(json.dumps(rec) + "\n")
            done[key] = rec
            print(f"  -> final {rec['val_acc_final']:.4f} "
                  f"best {rec['val_acc_best']:.4f}", file=sys.stderr)

    summary = {"model": args.model, "epochs": args.epochs, "seeds": seeds}
    per_dtype = {}
    for dtype in dtypes:
        recs = [done[(args.model, dtype, s, args.epochs,
                      tuple(args.extra))] for s in seeds]
        finals = [r["val_acc_final"] for r in recs]
        bests = [r["val_acc_best"] for r in recs]
        mf, sf = mean_sd(finals)
        mb, sb = mean_sd(bests)
        per_dtype[dtype] = {
            "final": finals, "best": bests,
            "final_mean": round(mf, 4), "final_sd": round(sf, 4),
            "best_mean": round(mb, 4), "best_sd": round(sb, 4),
        }
    summary["per_dtype"] = per_dtype
    if len(dtypes) == 2:
        a, b = dtypes
        # paired per-seed deltas: same corpus, same init seed
        deltas = [x - y for x, y in zip(per_dtype[a]["final"],
                                        per_dtype[b]["final"])]
        md, sd = mean_sd(deltas)
        summary["paired_final_delta"] = {
            f"{a}_minus_{b}": [round(d, 4) for d in deltas],
            "mean": round(md, 4), "sd": round(sd, 4),
            "se": round(sd / math.sqrt(len(deltas)), 4)
            if len(deltas) > 1 else None,
        }
    int8 = [r["int8_delta"] for r in done.values() if "int8_delta" in r]
    if int8:
        mi, si = mean_sd(int8)
        summary["int8_delta"] = {"values": int8, "mean": round(mi, 4),
                                 "sd": round(si, 4)}
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
