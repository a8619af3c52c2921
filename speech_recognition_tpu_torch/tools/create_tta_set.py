"""Speed-TTA set builder (the port's counterpart of
scripts/create_tta_set.py; parity: create_tta_set.py:9-26).

    python -m speech_recognition_tpu_torch.tools.create_tta_set \\
        [--test_dir data/test/audio] [--out_dir data/tta_test/audio] \\
        [--rate 0.9] [--batch_size 256] [--device cuda]

The flags and defaults are the JAX script's, plus ``--device`` (default
``cuda``; the CPU only when asked).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch


def main(argv: Optional[List[str]] = None) -> int:
    """Write the slow set; returns the number of clips."""
    p = argparse.ArgumentParser(
        description="Speed-TTA set builder (PyTorch port)")
    p.add_argument("--test_dir", default="data/test/audio")
    p.add_argument("--out_dir", default="data/tta_test/audio")
    p.add_argument("--rate", type=float, default=0.9)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    from speech_recognition_tpu_torch.device import require_cuda
    from speech_recognition_tpu_torch.tools.tta_set import build_tta_set

    device = (require_cuda() if args.device == "cuda"
              else torch.device(args.device))
    n = build_tta_set(args.test_dir, args.out_dir, rate=args.rate,
                      batch_size=args.batch_size, device=device)
    print(f"wrote {n} stretched clips to {args.out_dir}")
    return n


if __name__ == "__main__":
    main()
