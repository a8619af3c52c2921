"""Colored-noise background generation (the port's counterpart of
scripts/generate_noise.py; parity: generate_noise.py:7-17).

    python -m speech_recognition_tpu_torch.tools.generate_noise \\
        [--noise_dir data/train/audio/_background_noise_] \\
        [--colors blue brown violet] [--seconds 60] [--seed 0]

Writes ``custom_<color>_noise.wav`` for each color (``data/noise.py``,
numpy on the host; the JAX script's flags and files, bit for bit).
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Colored-noise background generation (PyTorch port)")
    p.add_argument("--noise_dir",
                   default="data/train/audio/_background_noise_")
    p.add_argument("--colors", nargs="+",
                   default=["blue", "brown", "violet"])
    p.add_argument("--seconds", type=int, default=60)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Write the files; returns their paths."""
    args = parse_args(argv)
    from speech_recognition_tpu_torch.data.noise import (
        generate_background_noise_files,
    )
    paths = generate_background_noise_files(
        args.noise_dir, colors=args.colors, seconds=args.seconds,
        seed=args.seed)
    print("Done!", paths)
    return paths


if __name__ == "__main__":
    main()
