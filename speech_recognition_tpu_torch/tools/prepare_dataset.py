"""Dataset preparation and verification (the port's counterpart of
scripts/prepare_dataset.py).

    python -m speech_recognition_tpu_torch.tools.prepare_dataset \\
        [--train_archive train.tar.gz] [--test_archive test.zip] \\
        [--data_root data]

Extracts the Kaggle TensorFlow Speech Recognition Challenge archives
(``.tar``, ``.tar.gz``, ``.tgz`` or ``.zip``) into ``--data_root``, or
takes an already-extracted tree, and checks its layout: the labelled
training WAVs under ``train/audio/<word>/`` against the reference's
count, every word directory of the 30 words, the background clips, and
the test WAVs. Exits 1 if the training tree is missing, empty or lacks a
word. No network access is attempted. The JAX script's flags, output
and exit codes; host only, no device.
"""

from __future__ import annotations

import argparse
import os
import sys
import tarfile
import zipfile
from typing import List, Optional

EXPECTED_TRAIN_FILES = 64_727       # train.py:21
EXPECTED_TEST_FILES = 158_538       # convert_from_see_v3_bugfix.py:66


def extract(archive: str, dest: str) -> None:
    os.makedirs(dest, exist_ok=True)
    if archive.endswith((".tar.gz", ".tgz", ".tar")):
        with tarfile.open(archive) as tf:
            tf.extractall(dest, filter="data")
    elif archive.endswith(".zip"):
        with zipfile.ZipFile(archive) as zf:
            zf.extractall(dest)
    else:
        raise ValueError(f"unknown archive format: {archive}")


def verify(data_root: str) -> bool:
    from speech_recognition_tpu_torch.labels import get_classes

    ok = True
    train_dir = os.path.join(data_root, "train", "audio")
    test_dir = os.path.join(data_root, "test", "audio")
    if os.path.isdir(train_dir):
        n = sum(len([f for f in files if f.endswith(".wav")])
                for _, _, files in os.walk(train_dir))
        bg = os.path.join(train_dir, "_background_noise_")
        n_bg = len([f for f in os.listdir(bg)
                    if f.endswith(".wav")]) if os.path.isdir(bg) else 0
        n -= n_bg
        status = "OK" if n == EXPECTED_TRAIN_FILES else "UNEXPECTED"
        print(f"train: {n} labeled wavs (+{n_bg} background) "
              f"[{status}; reference: {EXPECTED_TRAIN_FILES}]")
        ok &= n > 0
        missing = [w for w in get_classes(wanted_only=False)
                   if not os.path.isdir(os.path.join(train_dir, w))]
        if missing:
            print(f"missing word dirs: {missing}")
            ok = False
    else:
        print(f"train dir missing: {train_dir}")
        ok = False
    if os.path.isdir(test_dir):
        n = len([f for f in os.listdir(test_dir) if f.endswith(".wav")])
        status = "OK" if n == EXPECTED_TEST_FILES else "UNEXPECTED"
        print(f"test: {n} wavs [{status}; reference: "
              f"{EXPECTED_TEST_FILES}]")
    else:
        print(f"test dir missing: {test_dir} (needed only for submission)")
    return ok


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Dataset preparation and verification (PyTorch port)")
    p.add_argument("--train_archive", default="",
                   help="train .tar.gz/.tgz/.tar/.zip to extract")
    p.add_argument("--test_archive", default="")
    p.add_argument("--data_root", default="data")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    """Extract and verify; returns the exit code (0 if the tree is
    usable)."""
    args = parse_args(argv)
    if args.train_archive:
        extract(args.train_archive, args.data_root)
    if args.test_archive:
        extract(args.test_archive, args.data_root)
    return 0 if verify(args.data_root) else 1


if __name__ == "__main__":
    sys.exit(main())
