"""Standalone checkpoint evaluation (the port's counterpart of
scripts/evaluate.py; parity: train.py:73-75 evaluate_generator and the
per-epoch confusion sweep).

    python -m speech_recognition_tpu_torch.tools.evaluate \\
        --checkpoint CKPT.pt [--data_dirs data/train/audio] \\
        [--mode validation] [--device cuda]

Restores a checkpoint of the port into a trainer over the corpus, sweeps
the partition (``Trainer.evaluate``) and prints the confusion matrix, the
loss, the accuracy and the mean per-class accuracy. The flags and
defaults are the JAX script's, plus ``--device`` (default ``cuda``; the
CPU only when asked).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Standalone checkpoint evaluation (PyTorch port)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--data_dirs", nargs="+", default=["data/train/audio"])
    p.add_argument("--model", default="conv_1d_time_sliced_with_attention")
    p.add_argument("--output_representation", default="raw")
    p.add_argument("--mode", default="validation",
                   choices=["validation", "testing", "training"])
    p.add_argument("--batch_size", type=int, default=384)
    p.add_argument("--wanted_only", action="store_true", default=True)
    p.add_argument("--all_words", dest="wanted_only", action="store_false")
    p.add_argument("--extend_reversed", action="store_true")
    p.add_argument("--window_size_ms", type=float, default=30.0)
    p.add_argument("--window_stride_ms", type=float, default=10.0)
    p.add_argument("--dct_coefficient_count", type=int, default=80)
    p.add_argument("--num_log_mel_features", type=int, default=60)
    p.add_argument("--silence_percentage", type=float, default=13.0)
    p.add_argument("--unknown_percentage", type=float, default=60.0)
    p.add_argument("--validation_percentage", type=float, default=10.0)
    p.add_argument("--testing_percentage", type=float, default=0.0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Print the reports; returns ``{"loss", "accuracy",
    "mean_per_class", "confusion"}``."""
    args = parse_args(argv)
    from speech_recognition_tpu_torch.config import (
        AugmentConfig, prepare_model_settings,
    )
    from speech_recognition_tpu_torch.data.device_bank import (
        build_device_dataset,
    )
    from speech_recognition_tpu_torch.data.index import build_dataset_index
    from speech_recognition_tpu_torch.device import require_cuda
    from speech_recognition_tpu_torch.labels import (
        get_classes, prepare_words_list,
    )
    from speech_recognition_tpu_torch.train.checkpoint import (
        restore_checkpoint,
    )
    from speech_recognition_tpu_torch.train.loop import Trainer
    from speech_recognition_tpu_torch.train.metrics import (
        accuracy, per_class_accuracies, render_confusion,
    )

    device = (require_cuda() if args.device == "cuda"
              else torch.device(args.device))
    classes = get_classes(wanted_only=args.wanted_only,
                          extend_reversed=args.extend_reversed)
    words = prepare_words_list(classes)
    settings = prepare_model_settings(
        label_count=len(words),
        window_size_ms=args.window_size_ms,
        window_stride_ms=args.window_stride_ms,
        dct_coefficient_count=args.dct_coefficient_count,
        num_log_mel_features=args.num_log_mel_features,
        output_representation=args.output_representation)
    index = build_dataset_index(
        data_dirs=args.data_dirs,
        silence_percentage=args.silence_percentage,
        unknown_percentage=args.unknown_percentage,
        wanted_words=classes,
        validation_percentage=args.validation_percentage,
        testing_percentage=args.testing_percentage)
    dataset = build_device_dataset(index, settings, device)
    trainer = Trainer(model_name=args.model, settings=settings,
                      dataset=dataset, augment=AugmentConfig(),
                      batch_size=args.batch_size)
    state = restore_checkpoint(args.checkpoint, trainer.init_state())
    conf, loss = trainer.evaluate(state, mode=args.mode)
    print(render_confusion(conf, words))
    accs = per_class_accuracies(conf)
    print(f"\n{args.mode}: loss={loss:.4f} accuracy={accuracy(conf):.4f} "
          f"mean_per_class={accs.mean():.4f}")
    return {"loss": loss, "accuracy": accuracy(conf),
            "mean_per_class": float(accs.mean()), "confusion": conf}


if __name__ == "__main__":
    main()
