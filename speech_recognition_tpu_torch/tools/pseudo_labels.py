"""Pseudo-label builders (parity: REPR_106_pseudo.py and
create_pseudo_with_thresh.py) and majority voting (majority_vote.py): the
port's counterpart of scripts/pseudo_labels.py.

    python -m speech_recognition_tpu_torch.tools.pseudo_labels \\
        {agreement,threshold,vote,convert} ...

The subcommands, flags and defaults are the JAX script's. Every one of
them reads and writes files on the host and runs nothing on a device, so
there is no ``--device``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Pseudo-label builders and majority voting "
                    "(PyTorch port)")
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("agreement", help="copy clips where N submissions "
                                         "agree (REPR_106_pseudo.py)")
    a.add_argument("--submissions", nargs="+", required=True)
    a.add_argument("--test_dir", default="data/test/audio")
    a.add_argument("--out_dir", default="data/pseudo/audio")
    a.add_argument("--min_agree", type=int, default=0)

    t = sub.add_parser("threshold", help="prob-threshold pseudo labels "
                                         "(create_pseudo_with_thresh.py)")
    t.add_argument("--submission_csv", required=True,
                   help="CSV giving the memmap row order")
    t.add_argument("--memmap", required=True)
    t.add_argument("--test_dir", default="data/test/audio")
    t.add_argument("--out_dir", default="data/heng_pseudo")
    t.add_argument("--prob_thresh", type=float, default=0.7)
    t.add_argument("--silence_group", type=int, default=30,
                   help="silence clips concatenated per synthetic "
                        "background WAV (create_pseudo_with_thresh.py:50)")

    v = sub.add_parser("vote", help="majority vote (majority_vote.py)")
    v.add_argument("--submissions", nargs="+", required=True)
    v.add_argument("--out", default="majority_sub.csv")
    v.add_argument("--min_count", type=int, default=3)
    v.add_argument("--test_dir", default="")
    v.add_argument("--split_decision_dir", default="")

    c = sub.add_parser("convert", help="32-class probs CSV -> 12-class "
                                       "uint8 memmap "
                                       "(convert_from_see_v3_bugfix.py)")
    c.add_argument("--probs_csv", required=True)
    c.add_argument("--memmap", required=True)
    c.add_argument("--extend_reversed", action="store_true")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    """Run one subcommand; returns what its tool function returned."""
    args = parse_args(argv)
    if args.cmd == "agreement":
        from speech_recognition_tpu_torch.tools.pseudo import (
            pseudo_by_agreement,
        )
        n = pseudo_by_agreement(args.submissions, args.test_dir,
                                args.out_dir,
                                min_agree=args.min_agree or None)
        print(f"{n} pseudo labels created in {args.out_dir}")
        return n
    if args.cmd == "threshold":
        from speech_recognition_tpu_torch.infer.submission import (
            read_uint8_memmap,
        )
        from speech_recognition_tpu_torch.tools.pseudo import (
            pseudo_by_threshold, read_submission_csv,
        )
        fnames, _ = read_submission_csv(args.submission_csv)
        probs = read_uint8_memmap(args.memmap, len(fnames))
        stats = pseudo_by_threshold(fnames, probs, args.test_dir,
                                    args.out_dir,
                                    prob_thresh=args.prob_thresh,
                                    silence_group=args.silence_group)
        print(f"{stats['created']} pseudo labels created; "
              f"{stats['low_prob']} below threshold")
        return stats
    if args.cmd == "vote":
        from speech_recognition_tpu_torch.tools.vote import majority_vote
        clear, total = majority_vote(
            args.submissions, args.out, min_count=args.min_count,
            test_audio_dir=args.test_dir or None,
            split_decision_dir=args.split_decision_dir or None)
        print(f"Done! Got a clear majority for {clear} of {total} samples.")
        return clear, total
    from speech_recognition_tpu_torch.tools.convert import (
        convert_probs_csv_to_memmap,
    )
    fnames, mapped = convert_probs_csv_to_memmap(
        args.probs_csv, args.memmap, extend_reversed=args.extend_reversed)
    print(f"wrote {mapped.shape} probs to {args.memmap}")
    return fnames, mapped


if __name__ == "__main__":
    main()
