"""Majority-vote ensembling (port of speech_recognition_tpu/tools/vote.py;
parity: majority_vote.py:15-65).

Per-clip vote across submission CSVs; ties (majority < min_count) fall
back to the best-leaderboard submission (the first path, matching
majority_vote.py:47-48), and the disputed clips can optionally be copied
aside for inspection (majority_vote.py:40-46).
"""

from __future__ import annotations

import csv
import os
import shutil
from typing import List, Optional, Sequence, Tuple

from speech_recognition_tpu_torch.tools.pseudo import read_submission_csv


def majority_vote(submission_paths: Sequence[str],
                  out_path: str,
                  min_count: int = 3,
                  test_audio_dir: Optional[str] = None,
                  split_decision_dir: Optional[str] = None,
                  ) -> Tuple[int, int]:
    """Write the voted submission; returns (clear_majority, total)."""
    subs = [read_submission_csv(p) for p in submission_paths]
    fnames = subs[0][0]
    clear = 0
    out_labels: List[str] = []
    for i, fn in enumerate(fnames):
        counts = {}
        for _, labels in subs:
            counts[labels[i]] = counts.get(labels[i], 0) + 1
        maj_label = max(counts, key=counts.get)
        if counts[maj_label] >= min_count:
            clear += 1
        else:
            if split_decision_dir and test_audio_dir:
                os.makedirs(split_decision_dir, exist_ok=True)
                tag = "_".join(f"{k}{v}" for k, v in sorted(counts.items()))
                shutil.copy(
                    os.path.join(test_audio_dir, fn),
                    os.path.join(split_decision_dir, f"{tag}_{fn}"))
            # tie-break: best-PLB submission wins (majority_vote.py:47-48)
            maj_label = subs[0][1][i]
        out_labels.append(maj_label)
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["fname", "label"])
        w.writerows(zip(fnames, out_labels))
    return clear, len(fnames)
