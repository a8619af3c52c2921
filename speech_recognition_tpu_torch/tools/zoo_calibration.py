"""Reduced-schedule accuracy calibration across the zoo (the port's
counterpart of scripts/zoo_calibration.py).

    python -m speech_recognition_tpu_torch.tools.zoo_calibration \\
        [--models NAME ...] [--epochs 12] [--clips_per_word 100] \\
        [--seed 0] [--out FILE.jsonl] [--extra ...] [--device cuda]

Runs ``python -m speech_recognition_tpu_torch.tools.calibrate_accuracy``
for every registry model (or ``--models``) on the hard corpus at a
reduced schedule, one fresh interpreter per model, appends a record per
model to a resumable JSONL (a model whose record is there is skipped; a
run that fails or times out is recorded with its error), and prints a
markdown table. The representation comes from the registry
(``calibrate_accuracy --output_representation auto``). The JAX script's
flags and table, plus ``--device`` (passed through; default ``cuda``).
The default ``--out`` is ``docs/sweeps/torch_zoo_calibration.jsonl`` in
the repository.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
from typing import Dict, List, Optional

from speech_recognition_tpu_torch.tools.seed_sweep import (
    CALIBRATE, REPO, last_record, run_calibration,
)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Zoo accuracy calibration (PyTorch port)")
    p.add_argument("--models", nargs="*", default=None,
                   help="default: all registry models")
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--clips_per_word", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=str(REPO / "docs" / "sweeps" /
                                        "torch_zoo_calibration.jsonl"))
    p.add_argument("--timeout", type=int, default=2400)
    p.add_argument("--extra", nargs="*", default=[])
    p.add_argument("--device", default="cuda",
                   help="passed to calibrate_accuracy: 'cuda' (default) or "
                        "'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the missing models and print the table; returns the records
    by model."""
    args = parse_args(argv)
    from speech_recognition_tpu_torch.models.zoo import MODEL_REGISTRY

    models = args.models or list(MODEL_REGISTRY)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    done = {}
    if out.exists():
        for line in out.read_text().splitlines():
            if line.strip():
                rec = json.loads(line)
                done[(rec["model"], rec["epochs"],
                      rec["clips_per_word"])] = rec

    for model in models:
        key = (model, args.epochs, args.clips_per_word)
        if key in done:
            print(f"skip (cached): {model}", file=sys.stderr)
            continue
        cmd = [sys.executable, "-m", CALIBRATE,
               "--model", model, "--epochs", str(args.epochs),
               "--clips_per_word", str(args.clips_per_word),
               "--seed", str(args.seed), "--device", args.device,
               *args.extra]
        print(f"run: {model}", file=sys.stderr)
        try:
            proc = run_calibration(cmd, args.timeout)
        except subprocess.TimeoutExpired:
            rec = {"model": model, "epochs": args.epochs,
                   "clips_per_word": args.clips_per_word,
                   "error": f"timeout {args.timeout}s"}
        else:
            rec = last_record(proc.stdout)
            if proc.returncode != 0 or rec is None:
                rec = {"model": model, "epochs": args.epochs,
                       "clips_per_word": args.clips_per_word,
                       "error": f"rc={proc.returncode}: "
                                f"{proc.stderr[-400:]}"}
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        done[key] = rec
        if "error" in rec:
            print(f"  -> ERROR {rec['error'][:200]}", file=sys.stderr)
        else:
            print(f"  -> final {rec['val_acc_final']:.4f} "
                  f"best {rec['val_acc_best']:.4f}", file=sys.stderr)

    print("| model | representation | val acc final | val acc best |")
    print("|---|---|---|---|")
    for model in models:
        rec = done[(model, args.epochs, args.clips_per_word)]
        if "error" in rec:
            print(f"| {model} | — | error | error |")
        else:
            print(f"| {model} | {rec.get('representation', '?')} "
                  f"| {rec['val_acc_final']:.4f} "
                  f"| {rec['val_acc_best']:.4f} |")
    return {m: done[(m, args.epochs, args.clips_per_word)] for m in models}


if __name__ == "__main__":
    main()
